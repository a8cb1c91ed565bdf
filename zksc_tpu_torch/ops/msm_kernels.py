"""Wrapper of the hand-written CUDA kernel for the double-and-add ladder MSM.

  - ladder (K3): replaces zksc_tpu/ops/pallas_msm.py:msm_g1_pallas (body
    _ladder_tile_kernel), for G1 and G2.

Source: ``csrc/msm_kernels.cu`` (with ``csrc/bn254.cuh``), compiled for
sm_90a by one plain ``nvcc`` call into ``build/libzksc_msm.so`` at first use
(ops/cuda_build.py) and loaded with ctypes.

Per lane an MSB-first ladder: acc <- 2 acc, then acc <- acc + P_i (complete
addition) where the bit is set. Unreduced (``seg=None``) it returns every
lane's s_i * P_i; reduced it returns the sum of each run of ``seg`` lanes,
a halving tree over groups of up to ``GROUP`` lanes and then over the group
sums; with ``seg`` = all lanes it is the MSM msm_g1_pallas computes (for
G1), with no lane-count condition. The reduction's order is that of
``_grouped_reduce``, so the plain version below gives the kernel's limbs
exactly.

The kernel has two layouts (csrc/msm_kernels.cu), picked from the shape by
``_layout``: LANE, one thread (G2: one thread pair) per lane, for launches
that fill the card, and SPLIT, each lane's products spread over several
threads, for launches too small to. A SPLIT ladder is written unreduced and
reduced by LANE relaunches in the same order.

Dispatch: a tensor on the CPU goes to the plain PyTorch version (built on
ops/ec.py); a CUDA tensor goes to the kernel or the wrapper raises. There is
no fallback from the kernel to the plain version. ``LAUNCHES`` counts real
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, ec
from .ec import JacPoint
from .ec_kernels import _check, _is_fp2, _pad6, _stream

GROUP = 128            # lanes of one halving tree: csrc/msm_kernels.cu kLaneLanes
LANE, SPLIT = 0, 1     # the kernel's layouts (zksc_ladder's `layout`)
ROLES = 4              # threads (G2: pairs) per SPLIT lane: csrc/msm_kernels.cu kRoles

# The largest lane count K3 runs in SPLIT, G1 and G2 alike. Up to ~16K
# lanes a LANE launch is one block per SM at most and takes the same time
# whatever the count; SPLIT's time grows from ~4K lanes on, once its four
# threads per lane fill the schedulers. Measured in one run of
# chip_smoke.py's phase 3 sweep on one H100 (NVIDIA H100 80GB HBM3,
# 700.00 W), ms SPLIT vs LANE, per-lane / shared bits:
#   32 bits   G1  8,192 lanes 0.1728 vs 0.2614 / 0.1224 vs 0.1672
#                16,384 lanes 0.3430 vs 0.2609 / 0.2548 vs 0.1825
#             G2  8,192 lanes 0.9484 vs 1.0997 / 0.5159 vs 0.6617
#                16,384 lanes 1.6322 vs 1.1416 / 1.0983 vs 0.8619
#   254 bits  G1  8,192 lanes 1.3642 vs 2.0976 / 1.0282 vs 1.4405
#                16,384 lanes 2.7515 vs 2.0925 / 2.0539 vs 1.4301
#             G2  8,192 lanes 7.6262 vs 8.9539 / 5.0506 vs 5.9667
#                16,384 lanes 12.8239 vs 9.2964 / 8.5840 vs 5.9214
# Neither the form nor the width of the bits moves the crossover, so the
# lane count alone picks the layout.
SPLIT_MAX_LANES = 8192

LAUNCHES = {"ladder": 0}


def reset_launch_counts():
    LAUNCHES["ladder"] = 0


def _declare(lib):
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.zksc_ladder.restype = ci
    lib.zksc_ladder.argtypes = ([ci, ci, ci, vp, cll, cll, ci] + [vp] * 12
                                + [cll, cll, cll, ci, vp])


def _lib():
    return cuda_build.load("msm", _declare)


def _lanes(fops, P: JacPoint) -> int:
    return fops.lane_width(P.x)


# ---------------------------------------------------------------- plain

def _grouped_reduce(fops, P: JacPoint, seg: int) -> JacPoint:
    """Sum of each run of `seg` lanes (a power of two) in the kernel's
    order: halving trees (ec._segment_reduce) over groups of up to GROUP
    lanes, then over the group sums until one point per segment is left."""
    while seg > 1:
        g = min(seg, GROUP)
        P = ec._segment_reduce(fops, P, g)
        seg //= g
    return P


def ladder_plain(fops, points: JacPoint, bits, n_bits: int,
                 seg: int | None = None) -> JacPoint:
    """Plain PyTorch K3: the loop body of pallas_msm._ladder_tile_kernel
    (jac_double, complete jac_add, select on the bit) on every lane, then
    _grouped_reduce when `seg` is given. bits: int [n_bits, N] per lane, or
    [n_bits] shared by every lane."""
    acc = ec._batch_scale(fops, points, n_bits, bits)
    if seg is not None:
        acc = _grouped_reduce(fops, acc, seg)
    return JacPoint(*(a.to(torch.int32) for a in acc))


# ---------------------------------------------------------------- K3

def _layout(n_lanes: int) -> int:
    """SPLIT for launches too small to fill the card, else LANE."""
    return SPLIT if n_lanes <= SPLIT_MAX_LANES else LANE


def _launch(fops, P: JacPoint, bits, n_bits: int, run_ladder: bool,
            group: int, layout: int = LANE) -> JacPoint:
    g2 = _is_fp2(fops)
    ld = P.x.shape[1]
    N = ld // 2 if g2 else ld
    n_out = N // group
    out = JacPoint(*(torch.empty((16, 2 * n_out if g2 else n_out),
                                 dtype=torch.int32, device=P.x.device)
                     for _ in range(3)))

    def ptrs(pt, lanes):
        if g2:
            return [p for a in pt for p in (a.data_ptr(), a.data_ptr() + 4 * lanes)]
        return _pad6([a.data_ptr() for a in pt])

    if bits is None:
        bptr, row, lane = None, 0, 0
    elif bits.dim() == 1:
        bptr, row, lane = bits.data_ptr(), 1, 0
    else:
        bptr, row, lane = bits.data_ptr(), N, 1
    rc = _lib().zksc_ladder(layout, int(g2), int(run_ladder), bptr, row, lane,
                            n_bits, *ptrs(P, N), *ptrs(out, n_out), N, ld,
                            out.x.shape[1], group, _stream(P.x))
    if rc != 0:
        raise RuntimeError(f"ladder kernel launch failed: cudaError {rc}")
    LAUNCHES["ladder"] += 1
    return out


def _ladder(fops, points: JacPoint, bits, n_bits: int, seg, layout: int) -> JacPoint:
    """K3 in the given layout: the ladder launch, reduced in the block
    (LANE) or not (SPLIT), then LANE relaunches (no ladder) over the
    partial sums until one point per segment is left."""
    g = 1 if seg is None or layout != LANE else min(seg, GROUP)
    out = _launch(fops, points, bits, n_bits, True, g, layout)
    seg = 1 if seg is None else seg // g
    while seg > 1:
        g = min(seg, GROUP)
        out = _launch(fops, out, None, 0, False, g)
        seg //= g
    return out


def ladder(fops, points: JacPoint, bits, n_bits: int,
           seg: int | None = None) -> JacPoint:
    """s_i * P_i for every lane (seg None), or the sum over each run of
    `seg` lanes (a power of two dividing the lane count): K3.

    points: JacPoint [16, N] (G2: folded [16, 2N]). bits: int32 [n_bits, N]
    (bit k of lane i's scalar, little-endian) or [n_bits] shared by every
    lane."""
    if points.x.device.type == "cpu":
        return ladder_plain(fops, points, bits, n_bits, seg)
    shape = tuple(points.x.shape)
    if len(shape) != 2 or shape[0] != 16:
        raise ValueError(f"ladder: expected [16, lanes], got {shape}")
    for c, a in zip("xyz", points):
        _check(a, shape, f"ladder points.{c}")
    N = _lanes(fops, points)
    want = (n_bits,) if bits.dim() == 1 else (n_bits, N)
    _check(bits, want, "ladder bits")
    if seg is not None and (seg < 1 or seg & (seg - 1) or N % seg):
        raise ValueError(f"ladder: segment {seg} is not a power of two "
                         f"dividing {N} lanes")
    if N == 0:
        return JacPoint(*(torch.empty_like(a) for a in points))
    return _ladder(fops, points, bits, n_bits, seg, _layout(N))

"""Wrapper of the hand-written CUDA kernel for the double-and-add ladder MSM.

  - ladder (K3): replaces zksc_tpu/ops/pallas_msm.py:msm_g1_pallas (body
    _ladder_tile_kernel), for G1 and G2.

Source: ``csrc/msm_kernels.cu`` (with ``csrc/bn254.cuh``), compiled for
sm_90a by one plain ``nvcc`` call into ``build/libzksc_msm.so`` at first use
(ops/cuda_build.py) and loaded with ctypes.

Per lane an MSB-first ladder: acc <- 2 acc, then acc <- acc + P_i (complete
addition) where the bit is set. Unreduced (``seg=None``) it returns every
lane's s_i * P_i; reduced it returns the sum of each run of ``seg`` lanes,
reduced inside blocks of ``BLOCK`` lanes and then over the block partials by
further launches; with ``seg`` = all lanes it is the MSM msm_g1_pallas
computes (for G1), with no lane-count condition. The reduction's order is
that of ``_grouped_reduce``, so the plain version below gives the kernel's
limbs exactly.

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

BLOCK = 128            # lanes per block: csrc/msm_kernels.cu kLadderThreads

LAUNCHES = {"ladder": 0}


def reset_launch_counts():
    LAUNCHES["ladder"] = 0


def _declare(lib):
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.zksc_ladder.restype = ci
    lib.zksc_ladder.argtypes = ([ci, ci, vp, cll, cll, ci] + [vp] * 12
                                + [cll, cll, cll, ci, vp])


def _lib():
    return cuda_build.load("msm", _declare)


def _lanes(fops, P: JacPoint) -> int:
    return fops.lane_width(P.x)


# ---------------------------------------------------------------- plain

def _grouped_reduce(fops, P: JacPoint, seg: int) -> JacPoint:
    """Sum of each run of `seg` lanes (a power of two) in the kernel's
    order: halving trees (ec._segment_reduce) over groups of up to BLOCK
    lanes, then over the group sums until one point per segment is left."""
    while seg > 1:
        g = min(seg, BLOCK)
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

def _launch(fops, P: JacPoint, bits, n_bits: int, run_ladder: bool,
            group: int) -> JacPoint:
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
    rc = _lib().zksc_ladder(int(g2), int(run_ladder), bptr, row, lane, n_bits,
                            *ptrs(P, N), *ptrs(out, n_out), N, ld,
                            out.x.shape[1], group, _stream(P.x))
    if rc != 0:
        raise RuntimeError(f"ladder kernel launch failed: cudaError {rc}")
    LAUNCHES["ladder"] += 1
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
    if seg is None:
        return _launch(fops, points, bits, n_bits, True, 1)
    g = min(seg, BLOCK)
    out = _launch(fops, points, bits, n_bits, True, g)
    seg //= g
    while seg > 1:
        g = min(seg, BLOCK)
        out = _launch(fops, out, None, 0, False, g)
        seg //= g
    return out

"""Wrappers of the hand-written CUDA kernels for the bucket MSM's point adds.

  - chunk_scan (K1): replaces zksc_tpu/ops/pallas_ec.py:chunk_scan.
  - jac_add_n  (K2): replaces zksc_tpu/ops/pallas_ec.py:jac_add_n.

Sources: ``csrc/ec_kernels.cu`` (kernels, C entry points) and
``csrc/bn254.cuh`` (field arithmetic and point formulas), compiled for
sm_90a by one plain ``nvcc`` call into ``build/libzksc_ec.so`` at first use
(ops/cuda_build.py) and loaded with ctypes.

Layouts: a G1 coordinate is [16, n] (limb-major); a G2 coordinate is the
folded [16, 2n] ([c0 | c1]) or a [16, 2, n] view of one. Both kernels read
their inputs in place with any row stride, as long as the lane stride is 1
(the halving reduce hands K2 the two halves of one array), and write dense
outputs in the folded layout. K1 works on the layout the MSM's scan holds,
step-major: lane = step * C + chunk.

Dispatch: a tensor on the CPU goes to the plain PyTorch version in this
module (built on ops/ec.py); a CUDA tensor goes to the kernel, which
launches on the current stream without synchronising, or the wrapper
raises. There is no fallback from the kernel to the plain version.

``LAUNCHES`` counts kernel launches per wrapper (only real launches).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, ec
from .ec import JacPoint

LAUNCHES = {"chunk_scan": 0, "jac_add_n": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib):
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.zksc_chunk_scan.restype = ci
    lib.zksc_chunk_scan.argtypes = [ci, ci, ptrs, cll, ptrs, cll, ptrs, cll,
                                    ci, cll, ci, vp]
    lib.zksc_jac_add_n.restype = ci
    lib.zksc_jac_add_n.argtypes = [ci, ci, ptrs, cll, ptrs, cll, ptrs, cll,
                                   cll, vp]


def _lib():
    return cuda_build.load("ec", _declare)


def _is_fp2(fops) -> bool:
    return isinstance(fops, ec.Fp2Ops)


def _require_cuda(t: torch.Tensor, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")


def _check(t: torch.Tensor, shape: tuple, what: str):
    _require_cuda(t, what)
    if t.dtype != torch.int32:
        raise ValueError(f"{what}: expected int32 limbs, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _pad6(ptrs: list) -> list:
    return ptrs + [None] * (6 - len(ptrs))


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _lanes(fops, a: torch.Tensor) -> int:
    return a.shape[-1] if a.dim() == 3 else fops.lane_width(a)


def _operand(fops, P: JacPoint, what: str):
    """(six component pointers, row stride, lanes) of a point the kernels
    read or write in place. G1: [16, n]; G2: folded [16, 2n] (c1 = c0 + n)
    or a [16, 2, n] view; any row stride, lane stride 1, int32 on the GPU,
    and one layout for x, y and z. Raises on anything else."""
    g2 = _is_fp2(fops)
    a0 = P.x
    n = _lanes(fops, a0)
    dims = (3,) if g2 and a0.dim() == 3 else (2,)
    ptrs = []
    for c, a in zip("xyz", P):
        where = f"{what}.{c}"
        _require_cuda(a, where)
        if a.dtype != torch.int32:
            raise ValueError(f"{where}: expected int32 limbs, got {a.dtype}")
        if a.dim() not in dims or a.shape[0] != 16 \
                or a.shape != a0.shape or a.stride() != a0.stride():
            raise ValueError(f"{where}: expected x, y, z of one layout "
                             f"[16, {'2, n' if dims == (3,) else 'lanes'}], "
                             f"got shape {tuple(a.shape)} strides {a.stride()}")
        if n > 1 and a.stride(-1) != 1:
            raise ValueError(f"{where}: lane stride must be 1, got {a.stride()}")
        if g2 and a.dim() == 2 and a.shape[1] % 2:
            raise ValueError(f"{where}: folded G2 width must be even")
        if g2 and a.dim() == 3 and a.shape[1] != 2:
            raise ValueError(f"{where}: expected [16, 2, n], got {tuple(a.shape)}")
        base = a.data_ptr()
        if g2:
            off = a.stride(1) if a.dim() == 3 else n
            ptrs += [base, base + 4 * off]
        else:
            ptrs.append(base)
    ld = a0.stride(0)
    if ld < 1:
        raise ValueError(f"{what}: row stride must be positive, got {ld}")
    return (ctypes.c_void_p * 6)(*_pad6(ptrs)), ld, n


def _empty_like_lanes(fops, n: int, device) -> JacPoint:
    w = 2 * n if _is_fp2(fops) else n
    return JacPoint(*(torch.empty((16, w), dtype=torch.int32, device=device)
                      for _ in range(3)))


def folded(fops, P: JacPoint) -> JacPoint:
    """P with G2 coordinates given as [16, 2, n] views made folded
    [16, 2n] tensors (a copy); any other point as it is."""
    if _is_fp2(fops) and P.x.dim() == 3:
        return JacPoint(*(a.reshape(a.shape[0], -1) for a in P))
    return P


# ---------------------------------------------------------------- K1

def _carry_order(carry, carry_steps: int):
    """Chunk totals in chunk order -> the order K1 writes them: for a next
    level of `carry_steps` steps, that level's step-major lanes."""
    if carry_steps == 1:
        return carry
    C = carry.shape[-1]
    return carry.reshape(16, C // carry_steps, carry_steps).transpose(1, 2) \
        .reshape(16, C)


def chunk_scan_plain(fops, pts: JacPoint, S: int, inclusive: bool,
                     carry_steps: int = 1):
    """Plain PyTorch K1: the loop body of pallas_ec._scan_kernel, on the
    step-major layout."""
    P = folded(fops, pts)
    N = fops.lane_width(P.x)
    C = N // S
    acc = ec.jac_identity_batch(fops, (C,), device=P.x.device)
    outs = []
    for s in range(S):
        step = JacPoint(*(fops.lane_map(lambda a: a[:, s * C:(s + 1) * C], c)
                          for c in P))
        summed = ec.jac_add(fops, acc, step)
        outs.append(summed if inclusive else acc)
        acc = summed
    cat = lambda arrs: torch.cat(arrs, dim=-1).to(torch.int32)
    if _is_fp2(fops):
        ys = [cat([o[c][:, :C] for o in outs] + [o[c][:, C:] for o in outs])
              for c in range(3)]
        carry = [torch.cat([_carry_order(a[:, :C], carry_steps),
                            _carry_order(a[:, C:], carry_steps)], dim=-1)
                 for a in acc]
    else:
        ys = [cat([o[c] for o in outs]) for c in range(3)]
        carry = [_carry_order(a, carry_steps) for a in acc]
    return JacPoint(*ys), JacPoint(*(a.to(torch.int32).contiguous() for a in carry))


def chunk_scan(fops, pts: JacPoint, S: int, inclusive: bool,
               carry_steps: int = 1):
    """Prefix-scan each of C chunks of S lanes (K1).

    pts: step-major points, lane = step * C + chunk (G1 [16, S*C]; G2 folded
    [16, 2*S*C] or a [16, 2, S*C] view), read in place. Returns (scanned,
    carry): the scanned values in the same layout (inclusive, or the
    accumulator before each add) and the C chunk totals, in chunk order, or
    (carry_steps > 1) in the step-major order of a next level that scans
    chunks of carry_steps totals."""
    if pts.x.device.type == "cpu":
        return chunk_scan_plain(fops, pts, S, inclusive, carry_steps)
    return _launch_chunk_scan(fops, pts, S, inclusive, carry_steps)


def _launch_chunk_scan(fops, pts: JacPoint, S: int, inclusive: bool,
                       carry_steps: int = 1):
    src, ld, N = _operand(fops, pts, "chunk_scan pts")
    if S < 1 or N % S:
        raise ValueError(f"chunk_scan: {N} lanes are not chunks of {S}")
    C = N // S
    if carry_steps < 1 or C % carry_steps:
        raise ValueError(f"chunk_scan: {C} chunk totals are not steps of "
                         f"{carry_steps}")
    dev = pts.x.device
    ys, carry = _empty_like_lanes(fops, N, dev), _empty_like_lanes(fops, C, dev)
    if C == 0:
        return ys, carry
    out, out_ld, _ = _operand(fops, ys, "chunk_scan out")
    tot, tot_ld, _ = _operand(fops, carry, "chunk_scan carry")
    rc = _lib().zksc_chunk_scan(int(_is_fp2(fops)), int(inclusive), src, ld,
                                out, out_ld, tot, tot_ld, S, C, carry_steps,
                                _stream(pts.x))
    if rc != 0:
        raise RuntimeError(f"chunk_scan kernel launch failed: cudaError {rc}")
    LAUNCHES["chunk_scan"] += 1
    return ys, carry


# ---------------------------------------------------------------- K2

def jac_add_n_plain(fops, P: JacPoint, Q: JacPoint, complete: bool = True):
    """Plain PyTorch K2: ec.jac_add / ec.jac_add_incomplete."""
    R = (ec.jac_add if complete else ec.jac_add_incomplete)(
        fops, folded(fops, P), folded(fops, Q))
    return JacPoint(*(a.to(torch.int32) for a in R))


def jac_add_n(fops, P: JacPoint, Q: JacPoint, complete: bool = True):
    """Elementwise point add over the lane axis (K2). Coordinates: G1
    [16, N]; G2 folded [16, 2N] or [16, 2, N] views, read in place with any
    row stride. Returns dense [16, N] (G2 folded [16, 2N]) coordinates."""
    if P.x.device.type == "cpu":
        return jac_add_n_plain(fops, P, Q, complete)
    return _launch_jac_add_n(fops, P, Q, complete)


def _launch_jac_add_n(fops, P: JacPoint, Q: JacPoint, complete: bool):
    p, p_ld, N = _operand(fops, P, "jac_add_n P")
    q, q_ld, NQ = _operand(fops, Q, "jac_add_n Q")
    if NQ != N:
        raise ValueError(f"jac_add_n: P has {N} lanes, Q {NQ}")
    R = _empty_like_lanes(fops, N, P.x.device)
    if N == 0:
        return R
    r, r_ld, _ = _operand(fops, R, "jac_add_n R")
    rc = _lib().zksc_jac_add_n(int(_is_fp2(fops)), int(complete), p, p_ld, q,
                               q_ld, r, r_ld, N, _stream(P.x))
    if rc != 0:
        raise RuntimeError(f"jac_add_n kernel launch failed: cudaError {rc}")
    LAUNCHES["jac_add_n"] += 1
    return R

"""Wrappers of the hand-written CUDA kernels for the bucket MSM's point adds.

  - chunk_scan (K1): replaces zksc_tpu/ops/pallas_ec.py:chunk_scan.
  - jac_add_n  (K2): replaces zksc_tpu/ops/pallas_ec.py:jac_add_n.

Sources: ``csrc/ec_kernels.cu`` (kernels, C entry points) and
``csrc/bn254.cuh`` (field arithmetic), compiled for sm_90a by one plain
``nvcc`` call into ``build/libzksc_ec.so`` at first use (ops/cuda_build.py)
and loaded with ctypes.

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
    lib.zksc_chunk_scan.restype = ci
    lib.zksc_chunk_scan.argtypes = [ci, ci] + [vp] * 18 + [ci, cll, vp]
    lib.zksc_jac_add_n.restype = ci
    lib.zksc_jac_add_n.argtypes = [ci, ci] + [vp] * 18 + [cll, cll, vp]


def _lib():
    return cuda_build.load("ec", _declare)


def _is_fp2(fops) -> bool:
    return isinstance(fops, ec.Fp2Ops)


def _check(t: torch.Tensor, shape: tuple, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
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


def join_coords(fops, arrs) -> JacPoint:
    """Flat list of raw arrays (Fp2: component halves) -> folded JacPoint."""
    if _is_fp2(fops):
        cat = lambda a, b: torch.cat([a, b], dim=-1)
        return JacPoint(cat(arrs[0], arrs[1]), cat(arrs[2], arrs[3]),
                        cat(arrs[4], arrs[5]))
    return JacPoint(*arrs)


def split_coords(fops, P: JacPoint) -> list:
    """Folded JacPoint -> flat list of raw arrays (Fp2: component halves)."""
    if _is_fp2(fops):
        out = []
        for a in (P.x, P.y, P.z):
            n = a.shape[-1] // 2
            out += [a[..., :n], a[..., n:]]
        return out
    return [P.x, P.y, P.z]


# ---------------------------------------------------------------- K1

def chunk_scan_plain(fops, xs, S: int, inclusive: bool):
    """Plain PyTorch K1: the loop body of pallas_ec._scan_kernel."""
    C = xs[0].shape[-1]
    acc = ec.jac_identity_batch(fops, (C,), device=xs[0].device)
    outs = [[] for _ in xs]
    for s in range(S):
        summed = ec.jac_add(fops, acc, join_coords(fops, [x[s] for x in xs]))
        written = split_coords(fops, summed if inclusive else acc)
        for lst, a in zip(outs, written):
            lst.append(a)
        acc = summed
    ys = [torch.stack(lst).to(torch.int32) for lst in outs]
    carry = [a.to(torch.int32).contiguous() for a in split_coords(fops, acc)]
    return ys, carry


def chunk_scan(fops, xs, S: int, inclusive: bool):
    """Prefix-scan each of C lanes over S steps (K1).

    xs: n_arr step-major arrays [S, L, C] (3 for G1; 6 for G2, the Fp2
    component halves x0, x1, y0, y1, z0, z1). Returns (ys, carry): ys the
    same-shape scanned values, carry n_arr x [L, C] lane totals."""
    n_arr = 6 if _is_fp2(fops) else 3
    if len(xs) != n_arr:
        raise ValueError(f"chunk_scan: expected {n_arr} arrays, got {len(xs)}")
    if xs[0].device.type == "cpu":
        return chunk_scan_plain(fops, xs, S, inclusive)
    S_, L, C = xs[0].shape
    if S_ != S or L != 16:
        raise ValueError(f"chunk_scan: expected [S={S}, 16, C], "
                         f"got {tuple(xs[0].shape)}")
    for i, x in enumerate(xs):
        _check(x, (S, L, C), f"chunk_scan xs[{i}]")
    ys = [torch.empty_like(x) for x in xs]
    carry = [torch.empty((L, C), dtype=torch.int32, device=x.device) for x in xs]
    if C == 0:
        return ys, carry
    lib = _lib()
    ptrs = lambda ts: _pad6([t.data_ptr() for t in ts])
    rc = lib.zksc_chunk_scan(int(_is_fp2(fops)), int(inclusive), *ptrs(xs),
                             *ptrs(ys), *ptrs(carry), S, C, _stream(xs[0]))
    if rc != 0:
        raise RuntimeError(f"chunk_scan kernel launch failed: cudaError {rc}")
    LAUNCHES["chunk_scan"] += 1
    return ys, carry


# ---------------------------------------------------------------- K2

def jac_add_n_plain(fops, P: JacPoint, Q: JacPoint, complete: bool = True):
    """Plain PyTorch K2: ec.jac_add / ec.jac_add_incomplete."""
    R = (ec.jac_add if complete else ec.jac_add_incomplete)(fops, P, Q)
    return JacPoint(*(a.to(torch.int32) for a in R))


def jac_add_n(fops, P: JacPoint, Q: JacPoint, complete: bool = True):
    """Elementwise point add over the lane axis (K2). G1 coordinates are
    [L, N]; G2 coordinates the folded [L, 2N]."""
    if P.x.device.type == "cpu":
        return jac_add_n_plain(fops, P, Q, complete)
    shape = tuple(P.x.shape)
    if len(shape) != 2 or shape[0] != 16:
        raise ValueError(f"jac_add_n: expected [16, lanes], got {shape}")
    for name, pt in (("P", P), ("Q", Q)):
        for c, a in zip("xyz", pt):
            _check(a, shape, f"jac_add_n {name}.{c}")
    ld = shape[1]
    N = ld // 2 if _is_fp2(fops) else ld
    R = JacPoint(*(torch.empty_like(a) for a in P))
    if N == 0:
        return R

    def ptrs(pt):
        if _is_fp2(fops):
            off = N * 4                      # c1 half: N int32 lanes further
            return [p for a in pt for p in (a.data_ptr(), a.data_ptr() + off)]
        return _pad6([a.data_ptr() for a in pt])

    lib = _lib()
    rc = lib.zksc_jac_add_n(int(_is_fp2(fops)), int(complete), *ptrs(P),
                            *ptrs(Q), *ptrs(R), N, ld, _stream(P.x))
    if rc != 0:
        raise RuntimeError(f"jac_add_n kernel launch failed: cudaError {rc}")
    LAUNCHES["jac_add_n"] += 1
    return R

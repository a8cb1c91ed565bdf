"""Wrappers of the hand-written CUDA kernels of the bucket MSM's glue (K6):
the work of ``ops/msm.py:_window_sums`` around the point kernels K1 / K2,
which the reference leaves to XLA to fuse (zksc_tpu/ops/msm.py:202-282, no
pl.pallas_call) and which eager PyTorch ran as ~100 launches a MSM and a
host synchronisation.

  - keys (K6a): the digits of the scalar limbs, the segment-prefixed
    flipped keys and their histogram (zksc_tpu/ops/msm.py:67
    scalars_to_digits, :214-221).
  - sorted_gather (K6b): the points in the stable sort's order, written in
    K1's step-major level-0 layout (:225); two launches, the table packed
    point-major first.
  - scan_top (K6c): the prefix sum, under complete adds, of the scan's top
    level or of a whole small MSM (:164 _hs_scan), in the kernel's order
    (``scan_plan``): runs, tiles of runs, tiles.
  - bucket_boundaries (K6d): the bucket array the halving reduce reads:
    the prefix sums at the bucket boundaries, minus each segment's prefix,
    empty and digit-0 buckets masked (:241-273).

Source: ``csrc/msm_glue.cu`` (with ``csrc/bn254.cuh``'s point formulas),
compiled for sm_90a by one plain ``nvcc`` call into
``build/libzksc_msm_glue.so`` at first use (ops/cuda_build.py) and loaded
with ctypes.

Dispatch: a tensor on the CPU goes to the plain PyTorch version (the
``*_plain`` functions here, which run on CUDA tensors too); a CUDA tensor
goes to the kernel, which launches on the current stream without
synchronising, or the wrapper raises. There is no fallback from the kernel
to the plain version. ``LAUNCHES`` counts real kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..fields.limb import W as LIMB_W
from . import cuda_build, ec
from .ec import JacPoint
from .ec_kernels import _empty_like_lanes, _is_fp2, _operand, folded

LAUNCHES = {"msm_keys": 0, "sorted_gather": 0, "scan_top": 0,
            "bucket_boundaries": 0}

SCAN_STEPS = 16      # K1's chunk width, the step-major layouts' S (kScanSteps)
SCAN_THREADS = 128   # K6c's threads a block (kGlueThreads)
MAX_LEVELS = 8       # scan levels K6d reads, level 0 included (kMaxLevels)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib):
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lls = ctypes.POINTER(ctypes.c_longlong)
    lib.zksc_msm_keys.restype = ci
    lib.zksc_msm_keys.argtypes = [ci, vp, cll, cll, ci, ci, ci, ci, cll, vp,
                                  vp, vp]
    lib.zksc_sorted_gather.restype = ci
    lib.zksc_sorted_gather.argtypes = [ci, ptrs, cll, vp, ptrs, cll, vp, cll,
                                       cll, cll, vp]
    lib.zksc_scan_top.restype = ci
    lib.zksc_scan_top.argtypes = [ci, ci, ptrs, cll, ptrs, cll, ptrs, cll, cll,
                                  ci, ci, vp]
    lib.zksc_bucket_boundaries.restype = ci
    lib.zksc_bucket_boundaries.argtypes = [ci, ci, ptrs, lls, lls, lls, lls,
                                           vp, ptrs, cll, ptrs, cll, ci, cll,
                                           cll, cll, vp]


def _lib():
    return cuda_build.load("msm_glue", _declare)


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(t: torch.Tensor, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def _take(fops, P: JacPoint, idx) -> JacPoint:
    """Lanes idx of P (G2: of both halves), a copy."""
    return JacPoint(*(fops.lane_map(lambda a: a[:, idx], c) for c in P))


def _cat(fops, pts) -> JacPoint:
    """Points concatenated along the lane axis (G2 folded per half)."""
    if not _is_fp2(fops):
        return JacPoint(*(torch.cat([p[c] for p in pts], dim=-1)
                          for c in range(3)))
    out = []
    for c in range(3):
        halves = [fops._halves(p[c]) for p in pts]
        out.append(torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                             dim=-1))
    return JacPoint(*out)


def _select(fops, cond, A: JacPoint, B: JacPoint) -> JacPoint:
    return JacPoint(*(fops.select(cond, a, b) for a, b in zip(A, B)))


def _int32(P: JacPoint) -> JacPoint:
    return JacPoint(*(a.to(torch.int32).contiguous() for a in P))


# ---------------------------------------------------------------- K6a

def scalars_to_digits(scalars_plain, c: int, n_windows: int):
    """Non-Montgomery 16-bit limbs [L, *batch] -> digits int64
    [n_windows, *batch], digit w = scalar bits [w*c, (w+1)*c)."""
    assert c <= LIMB_W, "window must fit in two 16-bit limbs"
    s = scalars_plain.to(torch.int64)
    L = s.shape[0]
    outs = []
    for w in range(n_windows):
        lo_bit = w * c
        lo, off = lo_bit // LIMB_W, lo_bit % LIMB_W
        d = s[lo] >> off
        if off + c > LIMB_W and lo + 1 < L:
            d = d | (s[lo + 1] << (LIMB_W - off))
        outs.append(d & ((1 << c) - 1))
    return torch.stack(outs)


def key_dtype(segs: int, c: int):
    """int32 keys, as the reference's; int64 where segs * 2^c does not fit."""
    return torch.int32 if segs << c < 1 << 31 else torch.int64


def keys_plain(scalars, c: int, W: int):
    """Plain PyTorch K6a. scalars: plain limbs [L, k, n]. Returns (keys
    [k * W * n], position (j * W + w) * n + i holding (j * W + w) * 2^c +
    2^c - 1 - digit, int32 or int64 by key_dtype; counts [k * W * 2^c]
    int32, the keys' histogram)."""
    L, k, n = scalars.shape
    two_c, segs = 1 << c, k * W
    digits = scalars_to_digits(scalars, c, W).permute(1, 0, 2)   # [k, W, n]
    seg = torch.arange(segs, dtype=torch.int64,
                       device=scalars.device).reshape(k, W, 1)
    key = (seg * two_c + (two_c - 1) - digits).reshape(-1)
    counts = torch.bincount(key, minlength=segs * two_c)
    return key.to(key_dtype(segs, c)), counts.to(torch.int32)


def keys(scalars, c: int, W: int):
    """Segment-prefixed flipped keys and their histogram (K6a); see
    keys_plain. scalars: [L, k, n] int32, lane stride 1."""
    if scalars.device.type == "cpu":
        return keys_plain(scalars, c, W)
    return _launch_keys(scalars, c, W)


def _launch_keys(scalars, c: int, W: int):
    _require_cuda(scalars, "msm keys scalars")
    if scalars.dtype != torch.int32 or scalars.dim() != 3 \
            or (scalars.shape[2] > 1 and scalars.stride(2) != 1):
        raise ValueError("msm keys: expected int32 limbs [L, k, n] with lane "
                         f"stride 1, got {scalars.dtype} "
                         f"{tuple(scalars.shape)} {scalars.stride()}")
    L, k, n = scalars.shape
    if not 1 <= c <= LIMB_W or (W - 1) * c // LIMB_W >= L:
        raise ValueError(f"msm keys: {W} windows of {c} bits do not fit "
                         f"{L} limbs of {LIMB_W} bits")
    segs = k * W
    dt = key_dtype(segs, c)
    key = torch.empty(segs * n, dtype=dt, device=scalars.device)
    counts = torch.empty(segs << c, dtype=torch.int32, device=scalars.device)
    rc = _lib().zksc_msm_keys(int(dt == torch.int64), scalars.data_ptr(),
                              scalars.stride(0), scalars.stride(1), L, c, W, k,
                              n, key.data_ptr(), counts.data_ptr(),
                              _stream(scalars))
    _raise_on(rc, "msm_keys")
    LAUNCHES["msm_keys"] += 1
    return key, counts


# ---------------------------------------------------------------- K6b

def lane_of(pos, chunks: int | None):
    """Lane of sorted position pos in a level: step-major over `chunks`
    chunks (position chunk * S + step at lane step * chunks + chunk), or
    position order (chunks None). csrc/msm_glue.cu's lane_of."""
    if chunks is None:
        return pos
    return (pos % SCAN_STEPS) * chunks + pos // SCAN_STEPS


def lane_order(N: int, C0: int | None, device):
    """Sorted position held by each lane of a level of N lanes: the
    inverse of lane_of."""
    p = torch.arange(N, device=device)
    order = torch.empty_like(p)
    order[lane_of(p, C0)] = p
    return order


def sorted_gather_plain(fops, points: JacPoint, sidx, n: int,
                        C0: int | None):
    """Plain PyTorch K6b: lane l of the result is point sidx[p] % n, p the
    sorted position lane_order gives l."""
    order = (sidx % n)[lane_order(sidx.shape[0], C0, sidx.device)]
    return _int32(_take(fops, folded(fops, points), order))


def sorted_gather(fops, points: JacPoint, sidx, n: int, C0: int | None):
    """The points in sorted order, in K1's level-0 layout (K6b). points:
    the table [16, n] (G2 folded [16, 2n]); sidx: the stable sort's
    permutation of the N = segs * n keys, int64; C0: level 0's chunks, or
    None for position order. Returns [16, N] (G2 folded [16, 2N])."""
    if points.x.device.type == "cpu":
        return sorted_gather_plain(fops, points, sidx, n, C0)
    return _launch_sorted_gather(fops, points, sidx, n, C0)


def _launch_sorted_gather(fops, points: JacPoint, sidx, n: int,
                          C0: int | None):
    src, src_ld, n_pts = _operand(fops, points, "sorted_gather points")
    _require_cuda(sidx, "sorted_gather sidx")
    if sidx.dtype != torch.int64 or sidx.dim() != 1 \
            or not sidx.is_contiguous():
        raise ValueError("sorted_gather: expected a contiguous int64 sidx")
    N = sidx.shape[0]
    if n_pts != n or (C0 is not None and N != C0 * SCAN_STEPS):
        raise ValueError(f"sorted_gather: {n_pts} points for n = {n}, {N} "
                         f"positions for C0 = {C0}")
    out = _empty_like_lanes(fops, N, points.x.device)
    if N == 0:
        return out
    packed = torch.empty((n, 8 * (6 if _is_fp2(fops) else 3)),
                         dtype=torch.int32, device=points.x.device)
    dst, dst_ld, _ = _operand(fops, out, "sorted_gather out")
    rc = _lib().zksc_sorted_gather(int(_is_fp2(fops)), src, src_ld,
                                   packed.data_ptr(), dst, dst_ld,
                                   sidx.data_ptr(), n, N,
                                   0 if C0 is None else C0, _stream(sidx))
    _raise_on(rc, "sorted_gather")
    LAUNCHES["sorted_gather"] += 2
    return out


# ---------------------------------------------------------------- K6c

def scan_plan(T: int, g2: bool):
    """K6c's cut of T lanes: (P runs a tile, m lanes a run, B tiles), B <=
    P so that one block scans the tile totals."""
    P = SCAN_THREADS // (2 if g2 else 1)
    m = max(1, -(-T // (P * P)))
    runs = -(-T // m)
    return P, m, max(1, -(-runs // P))


def _hs_in_tiles(fops, v: JacPoint, width: int, rounds_below: int):
    """Inclusive Hillis-Steele scan of each tile of `width` lanes, lane s
    of a tile becoming v[s - d] + v[s] for d = 1, 2, ... < rounds_below."""
    R = fops.lane_width(v.x)
    r = torch.arange(R, device=v.x.device)
    slot = r % width
    d = 1
    while d < rounds_below:
        added = ec.jac_add(fops, _take(fops, v, (r - d).clamp(min=0)), v)
        v = _select(fops, slot >= d, added, v)
        d *= 2
    return v


def scan_top_plain(fops, pts: JacPoint, inclusive: bool) -> JacPoint:
    """Plain PyTorch K6c, in the kernel's order (scan_plan): each run's
    total, a Hillis-Steele scan of the run totals within each tile, one of
    the tile totals, then each run walked from its offset."""
    P_ = folded(fops, pts)
    T = fops.lane_width(P_.x)
    dev = P_.x.device
    P, m, B = scan_plan(T, _is_fp2(fops))
    R = B * P
    r = torch.arange(R, device=dev)
    ident = lambda n: ec.jac_identity_batch(fops, (n,), device=dev)

    def step(j):                            # lane r * m + j of each run
        i = r * m + j
        return _select(fops, i < T, _take(fops, P_, i.clamp(max=T - 1)),
                       ident(R))

    acc = ident(R)
    for j in range(m):
        acc = ec.jac_add(fops, acc, step(j))
    incl = _hs_in_tiles(fops, acc, P, P)
    off = _select(fops, r % P == 0, ident(R),
                  _take(fops, incl, (r - 1).clamp(min=0)))
    tiles = _hs_in_tiles(fops, _take(fops, incl, torch.arange(
        B, device=dev) * P + P - 1), B, B)
    b = r // P
    tile = _select(fops, b == 0, ident(R),
                   _take(fops, tiles, (b - 1).clamp(min=0)))
    off = ec.jac_add(fops, tile, off)
    outs = []
    for j in range(m):
        y = ec.jac_add(fops, off, step(j))
        outs.append(y if inclusive else off)
        off = y
    i = torch.arange(T, device=dev)
    return _int32(_take(fops, _cat(fops, outs), (i % m) * R + i // m))


def scan_top(fops, pts: JacPoint, inclusive: bool) -> JacPoint:
    """Prefix sum of T lanes under complete adds (K6c): inclusive, or the
    sum before each lane. pts: [16, T] (G2 folded [16, 2T] or a [16, 2, T]
    view), read in place. Returns dense [16, T] (G2 folded)."""
    if pts.x.device.type == "cpu":
        return scan_top_plain(fops, pts, inclusive)
    return _launch_scan_top(fops, pts, inclusive)


def _launch_scan_top(fops, pts: JacPoint, inclusive: bool) -> JacPoint:
    src, src_ld, T = _operand(fops, pts, "scan_top pts")
    dev = pts.x.device
    out = _empty_like_lanes(fops, T, dev)
    if T == 0:
        return out
    P, m, B = scan_plan(T, _is_fp2(fops))
    # the runs' inclusive sums in their tiles, passed from the totals launch
    # to the scanning one (B > 1)
    runs = _empty_like_lanes(fops, B * P if B > 1 else 1, dev)
    dst, dst_ld, _ = _operand(fops, out, "scan_top out")
    rs, rs_ld, _ = _operand(fops, runs, "scan_top runs")
    rc = _lib().zksc_scan_top(int(_is_fp2(fops)), int(inclusive), src, src_ld,
                              dst, dst_ld, rs, rs_ld, T, m, B, _stream(pts.x))
    _raise_on(rc, "scan_top")
    LAUNCHES["scan_top"] += 1 + (B > 1)
    return out


# ---------------------------------------------------------------- K6d

def _prefix(fops, levels, at):
    """Inclusive prefix sums at sorted positions `at`: level 0 there plus
    each upper level's offset (incomplete adds)."""
    s0, _, C0 = levels[0]
    acc = _take(fops, s0, lane_of(at, C0))
    for e, st, ch in levels[1:]:
        ep = torch.clamp(at // st, 0, fops.lane_width(e.x) - 1)
        acc = ec.jac_add_incomplete(fops, acc, _take(fops, e, lane_of(ep, ch)))
    return acc


def bucket_boundaries_plain(fops, levels, cum, c: int, n: int) -> JacPoint:
    """Plain PyTorch K6d (the reference's order)."""
    levels = [(folded(fops, P), st, ch) for P, st, ch in levels]
    dev = cum.device
    two_c = 1 << c
    segs = cum.shape[0]
    N = segs * n
    cnt = cum.T.to(torch.int64)                               # [2^c, segs]
    base = (torch.arange(segs, dtype=torch.int64, device=dev) * n)[None, :]
    V = _prefix(fops, levels, torch.clamp(base + cnt - 1, 0, N - 1).reshape(-1))
    # the segment prefix (all points of earlier segments): for segment s >
    # 0 the prefix at s * n - 1, negated; the identity for s == 0
    Pre = _prefix(fops, levels, torch.clamp(torch.arange(
        segs, dtype=torch.int64, device=dev) * n - 1, 0, N - 1))
    first_seg = torch.arange(segs, device=dev) == 0
    Pre = JacPoint(Pre.x, fops.neg(Pre.y),
                   fops.select(first_seg, fops.zeros_like(Pre.z), Pre.z))
    PreT = JacPoint(*(fops.lane_map(lambda a: a.repeat(1, two_c), a)
                      for a in Pre))
    T = ec.jac_add_incomplete(fops, V, PreT)
    # mask: empty prefix (cnt == 0) and the digit-0 bucket (q == 2^c - 1)
    q = torch.arange(two_c, device=dev).repeat_interleave(segs)
    valid = (cnt.reshape(-1) > 0) & (q != two_c - 1)
    return _int32(_select(fops, valid, T,
                          ec.jac_identity_batch(fops, (two_c * segs,),
                                                device=dev)))


def bucket_boundaries(fops, levels, cum, c: int, n: int) -> JacPoint:
    """The bucket array of the halving reduce (K6d): q-major lanes q * segs
    + s hold T_q of segment s, the sum of its points whose flipped digit is
    <= q, masked to the identity where empty and for the digit-0 bucket.
    levels: [(points, stride, chunks)], level 0 the inclusive scan (stride
    1), then each upper level's exclusive offsets (chunks None: position
    order); cum: [segs, 2^c] int32 cumulative counts. Returns [16, 2^c *
    segs] (G2 folded)."""
    if cum.device.type == "cpu":
        return bucket_boundaries_plain(fops, levels, cum, c, n)
    return _launch_bucket_boundaries(fops, levels, cum, c, n)


def _launch_bucket_boundaries(fops, levels, cum, c: int, n: int):
    _require_cuda(cum, "bucket_boundaries cum")
    segs = cum.shape[0]
    if cum.dtype != torch.int32 or tuple(cum.shape) != (segs, 1 << c) \
            or not cum.is_contiguous():
        raise ValueError(f"bucket_boundaries: expected contiguous int32 cum "
                         f"[segs, {1 << c}], got {cum.dtype} "
                         f"{tuple(cum.shape)}")
    if not 1 <= len(levels) <= MAX_LEVELS or levels[0][1] != 1:
        raise ValueError(f"bucket_boundaries: 1-{MAX_LEVELS} levels, the "
                         "first of stride 1")
    N = segs * n
    ptrs, lds, strides, chunks, lanes = [], [], [], [], []
    for l, (P, st, ch) in enumerate(levels):
        arr, ld, width = _operand(fops, P, f"bucket_boundaries level {l}")
        if ch is not None and width != ch * SCAN_STEPS or \
                l == 0 and width != N:
            raise ValueError(f"bucket_boundaries: level {l} has {width} "
                             f"lanes for {ch} chunks")
        ptrs += list(arr)
        lds.append(ld)
        strides.append(st)
        chunks.append(0 if ch is None else ch)
        lanes.append(width)
    L = len(levels)
    dev = cum.device
    pre = _empty_like_lanes(fops, segs, dev)
    out = _empty_like_lanes(fops, segs << c, dev)
    pr, pr_ld, _ = _operand(fops, pre, "bucket_boundaries pre")
    dst, dst_ld, _ = _operand(fops, out, "bucket_boundaries out")
    lla = ctypes.c_longlong * L
    rc = _lib().zksc_bucket_boundaries(
        int(_is_fp2(fops)), L, (ctypes.c_void_p * (6 * L))(*ptrs), lla(*lds),
        lla(*strides), lla(*chunks), lla(*lanes), cum.data_ptr(), pr, pr_ld,
        dst, dst_ld, c, segs, n, N, _stream(cum))
    _raise_on(rc, "bucket_boundaries")
    LAUNCHES["bucket_boundaries"] += 2
    return out

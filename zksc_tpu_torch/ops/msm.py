"""Pippenger multi-scalar multiplication (sort + prefix-scan buckets).

The formulation of the JAX package's ``ops/msm.py``, per c-bit window w:

  digit d_i = bits [w*c, (w+1)*c) of scalar_i
  window sum S_w = sum_{j>=1} T_j    (T_j = sum of P_i with d_i >= j)

Sorting a window's points by digit DESCENDING makes every T_j a prefix of
the sorted sequence, read off an inclusive prefix sum V at the bucket
boundaries. So per window:

  1. keys and their histogram from the scalar limbs (K6a,
     msm_glue.keys), one stable global sort of the keys (torch.sort, as
     the reference's lax.sort; windows and proofs concatenated with
     segment-prefixed keys), the cumulative counts (torch.cumsum)
  2. hierarchical prefix scan of EC adds over the sorted points: the
     sorted gather writes level 0 (K6b, msm_glue.sorted_gather), then
     chunk-local scans of _SCAN_S steps (K1, ec_kernels.chunk_scan) per
     level, each level held step-major so that K1 reads it coalesced and
     nothing is transposed, then the small top level (K6c,
     msm_glue.scan_top)
  3. the bucket boundaries (K6d, msm_glue.bucket_boundaries): V at the
     2^c bucket boundaries plus the upper levels' offsets, minus the
     segment prefix, empty buckets masked
  4. shrinking halving-tree reduce over the bucket axis -> S_w (K2 reads
     both halves of the bucket array in place)

  MSM = sum_w 2^{c*w} * S_w      (host Horner combine, msm_to_host_affine)

The trusted setup's fixed-base products (batch_scalar_mul_fixed_base) are
a table gather plus one incomplete add (K2) per 8-bit window.

The prefix scan and the bucket reduce use COMPLETE additions: P == Q occurs
structurally there (every window's segment holds the same point multiset,
and 0/1 witnesses make whole digit runs identical); an incomplete formula
silently zeroes them. Only the boundary corrections keep incomplete adds.

On a CUDA tensor a bucket MSM runs the hand-written kernels K6a, K6b, K1,
K6c and K6d, K2 only for the halving reduce, and of PyTorch only the sort
and the cumulative counts; nothing in it waits for the host, so the MSMs
of a proof queue back to back. On a CPU tensor each kernel's wrapper
takes its plain PyTorch version. K6c adds in its own order (runs and
tiles, msm_glue.scan_plan), not the reference's Hillis-Steele order: the
window sums are the same points, in other Jacobian representatives. Unlike
the JAX package there is no tile-multiple condition: every call takes the
kernel.

With a mesh (parallel/mesh.py), msm_pippenger_device splits the points
over the shards and each shard runs the whole pipeline on its own device
(_window_sums_sharded); msm_to_host_affine adds the shards' window sums.
"""
from __future__ import annotations

import time

import torch

from ..fields.limb import Fp, Fr
from . import ec, ec_kernels, msm_glue
from .ec import JacPoint
from .msm_glue import scalars_to_digits


def _jp(fops, fn, P: JacPoint) -> JacPoint:
    return JacPoint(fops.lane_map(fn, P.x), fops.lane_map(fn, P.y),
                    fops.lane_map(fn, P.z))


def _local_scan(fops, pts: JacPoint, S: int, inclusive: bool,
                carry_steps: int = 1):
    """Chunk-local prefix scan of C chunks of S lanes (K1), on the
    step-major layout the scan holds (lane = step * C + chunk), read and
    written in place. Returns (scanned, chunk totals); the totals in chunk
    order, or in the step-major order of a next level of carry_steps."""
    return ec_kernels.chunk_scan(fops, pts, S, inclusive, carry_steps)


def _lane_range(fops, P: JacPoint, lo: int, hi: int) -> JacPoint:
    """Lanes [lo, hi) of P as views that K2 reads in place (G2: [16, 2, n]
    over the folded layout), no copy."""
    if isinstance(fops, ec.Fp2Ops):
        return JacPoint(*(a.view(a.shape[0], 2, -1)[:, :, lo:hi] for a in P))
    return JacPoint(*(a[:, lo:hi] for a in P))


def _add_wide(fops, P: JacPoint, Q: JacPoint, complete: bool) -> JacPoint:
    """Elementwise point add (K2)."""
    return ec_kernels.jac_add_n(fops, P, Q, complete=complete)


_SCAN_S = msm_glue.SCAN_STEPS   # chunk width per hierarchy level
_HS_MAX = 8192                  # the top level (K6c) at/below this width


def _window_sums(fops, points: JacPoint, scalars, c: int, W: int):
    """Per-(proof, window) bucket-method sums.

    points: JacPoint [L, n] (shared table). scalars: plain limbs [L, k, n].
    Returns JacPoint [L, k*W]: lane j*W + w = S_w for proof j."""
    k, n = int(scalars.shape[1]), int(scalars.shape[2])
    two_c = 1 << c
    segs = k * W
    N = segs * n

    # ---- keys: segment-major, digit DESCENDING within segment ----
    key, counts = msm_glue.keys(scalars, c, W)
    # inclusive counts over flipped digit: cnt_ge(j) = cum[., 2^c-1-j]
    cum = torch.cumsum(counts.view(segs, two_c), dim=-1, dtype=torch.int32)
    # stable: ties keep index order within a segment, as lax.sort does
    _, sidx = torch.sort(key, stable=True)

    # ---- hierarchical prefix scan ----
    # K1 levels hold step-major lanes: the sorted gather writes level 0 in
    # that order and K1 writes each level's chunk totals where the next
    # level reads them, so no level is transposed. A level continues while
    # its chunk count is a multiple of _SCAN_S above _HS_MAX. levels:
    # (scan, position stride, step-major chunks or None), level 0 first.
    S = _SCAN_S
    deeper = lambda chunks: S if chunks > _HS_MAX and chunks % S == 0 else 1
    if N <= _HS_MAX or N % S:
        s0 = msm_glue.scan_top(
            fops, msm_glue.sorted_gather(fops, points, sidx, n, None), True)
        levels = [(s0, 1, None)]
    else:
        C0 = N // S
        s0, tot = _local_scan(fops, msm_glue.sorted_gather(
            fops, points, sidx, n, C0), S, True, deeper(C0))
        levels = [(s0, 1, C0)]
        stride, C = S, C0
        while deeper(C) > 1:
            C //= S
            e, tot = _local_scan(fops, tot, S, False, deeper(C))
            levels.append((e, stride, C))
            stride *= S
        levels.append((msm_glue.scan_top(fops, tot, False), stride, None))

    # ---- bucket boundaries (q-major lanes: lane = q*segs + s) ----
    T = msm_glue.bucket_boundaries(fops, levels, cum, c, n)

    # ---- shrinking halving reduce over the bucket axis ----
    half = two_c
    while half > 1:
        half //= 2
        T = _add_wide(fops, _lane_range(fops, T, 0, half * segs),
                      _lane_range(fops, T, half * segs, 2 * half * segs),
                      complete=True)
    return T                                                      # [L, segs]


def default_window_bits(n_bits: int, n: int) -> int:
    """Balance scan work (W * 1.3n) against bucket work (W * 2*2^c)."""
    best, best_cost = 8, None
    for c in range(6, 17):
        Wn = -(-n_bits // c)
        cost = Wn * (1.3 * n + 2.0 * (1 << c))
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def _fixed_base_combine(fops, table: JacPoint, digits, c: int) -> JacPoint:
    """result_i = sum_w table[w * 2^c + digits[w, i]]: one gather and one
    incomplete add (K2) per window."""
    W, n = digits.shape
    acc = ec.jac_identity_batch(fops, (n,), device=digits.device)
    for w in range(W):
        idx = w * (1 << c) + digits[w]
        pt = _jp(fops, lambda a: a[:, idx], table)
        acc = _add_wide(fops, acc, pt, complete=False)
    return acc


_FB_TABLES: dict = {}


def _fixed_base_table(base, g2: bool, c: int, n_bits: int, device):
    """Host-precomputed window table: entry w*2^c + d = d * 2^(c*w) * base
    (cached per base, window and device)."""
    from ..curve import bn254_host as host
    key = (base, g2, c, n_bits, str(device))
    if key in _FB_TABLES:
        return _FB_TABLES[key]
    add = host.g2_add if g2 else host.g1_add
    W = -(-n_bits // c)
    rows = []
    cur = base
    for _ in range(W):
        row = [None]
        acc = None
        for _ in range((1 << c) - 1):
            acc = add(acc, cur)
            row.append(acc)
        rows.extend(row)
        for _ in range(c):
            cur = add(cur, cur)
    conv = ec.g2_points_to_device if g2 else ec.g1_points_to_device
    dev = conv(Fp, rows, device=device)
    _FB_TABLES[key] = dev
    return dev


def batch_scalar_mul_fixed_base(scalars: list, base, g2: bool = False,
                                c: int = 8, n_bits: int = 254, device=None,
                                timings: dict | None = None) -> list:
    """[s_i * base] for many scalars against ONE fixed base (the trusted
    setup's hot loop): ceil(n_bits/c) table gathers and adds per lane
    instead of a 254-step ladder. Returns host affine points (None =
    identity). timings: optional dict whose fb_table_s, fb_combine_s and
    fb_affine_s grow by this call's seconds (the combine synchronised)."""
    from ..curve import bn254_host as host
    n = len(scalars)
    if n == 0:
        return []
    t0 = time.perf_counter()
    npad = max(1, 1 << (n - 1).bit_length())
    sp = Fr.to_device(list(scalars) + [0] * (npad - n), mont=False,
                      device=device)
    W = -(-n_bits // c)
    digits = scalars_to_digits(sp, c, W)
    table = _fixed_base_table(base, g2, c, n_bits, sp.device)
    t1 = time.perf_counter()
    fops = ec.G2_OPS if g2 else ec.G1_OPS
    acc = _fixed_base_combine(fops, table, digits, c)
    if timings is not None and acc.x.device.type == "cuda":
        torch.cuda.synchronize(acc.x.device)
    t2 = time.perf_counter()
    conv = ec.g2_jac_to_host_affine if g2 else ec.g1_jac_to_host_affine
    out = conv(fops.F, acc, host.P)[:n]
    if timings is not None:
        for k, v in (("fb_table_s", t1 - t0), ("fb_combine_s", t2 - t1),
                     ("fb_affine_s", time.perf_counter() - t2)):
            timings[k] = timings.get(k, 0.0) + v
    return out


def _window_sums_sharded(fops, points: JacPoint, scalars, c: int, W: int,
                         mesh) -> list:
    """Shard the POINT axis over the mesh: each shard runs the whole bucket
    pipeline (K6, K1 and K2 on its own device) on its n / D points and
    their scalars, since the bucket method is additive over a partition of
    the points. Returns the per-shard window sums, one JacPoint [L, k*W]
    per shard; the D partials are added on the host (msm_to_host_affine).
    G2 blocks keep both halves of their points (mesh.shard_jac unfolds (c0
    | c1)), so the shards split points, not components."""
    from ..parallel.mesh import shard_bits, shard_jac
    if not mesh.all_local:
        raise ValueError("the sharded MSM needs every shard in this process "
                         "(across processes, split the batch: host_slice)")
    pts = shard_jac(points, mesh, g2=isinstance(fops, ec.Fp2Ops))
    sps = shard_bits(scalars, mesh)
    return [_window_sums(fops, p, sp, c, W) for p, sp in zip(pts, sps)]


class MsmPending:
    """In-flight bucket MSM: the per-(shard, proof, window) sums live on
    the devices, one JacPoint [L, k*Wn] per shard; the tiny window combine
    happens at msm_to_host_affine time in host Jacobian bigints."""

    __slots__ = ("sums", "c", "Wn", "k", "D")

    def __init__(self, sums, c, Wn, k, D):
        self.sums, self.c, self.Wn, self.k, self.D = sums, c, Wn, k, D


def msm_pippenger_device(fops, points: JacPoint, scalars_plain, n_bits: int,
                         c: int | None = None, mesh=None) -> MsmPending:
    """Device half of the bucket MSM: returns an MsmPending whose window
    sums stay on the device. On a CUDA tensor it makes no synchronising
    call (the keys' histogram is K6a's, not bincount's), so the MSMs of a
    proof queue back-to-back and only msm_to_host_affine waits. With a mesh
    of D > 1 shards that tiles the n points, each shard sums its n / D
    points."""
    single = scalars_plain.dim() == 2
    sp = scalars_plain[:, None, :] if single else scalars_plain
    k, n = int(sp.shape[1]), int(sp.shape[2])
    if c is None:
        c = default_window_bits(n_bits, n)
    Wn = -(-n_bits // c)
    if mesh is not None and mesh.size > 1 and n % mesh.size == 0:
        sums = _window_sums_sharded(fops, points, sp, c, Wn, mesh)
    else:
        sums = [_window_sums(fops, points, sp, c, Wn)]
    return MsmPending(sums, c, Wn, k, len(sums))


def msm_to_host_affine(fops, pending: MsmPending, k: int) -> list:
    """Finalize an MsmPending: pull each shard's [L, k*Wn] window sums
    (lane j*Wn + w), add the D per-shard partials on the host (exact group
    math: the partition cannot change the result), then Horner-combine the
    windows in host Jacobian coordinates."""
    from ..curve import bn254_host as host

    g2 = isinstance(fops, ec.Fp2Ops)
    conv = ec.g2_jac_to_host_affine if g2 else ec.g1_jac_to_host_affine
    pts = [p for s in pending.sums for p in conv(fops.F, s, host.P)]
    c, Wn, D = pending.c, pending.Wn, pending.D
    out = []
    for j in range(k):
        wins = []
        for w in range(Wn):
            acc = None
            for d in range(D):
                p = pts[(d * pending.k + j) * Wn + w]
                if p is not None:
                    acc = host.jac_add_host(
                        acc, host.jac_from_affine_host(p, g2), g2)
            wins.append(host.jac_to_affine_host(acc, g2))
        out.append(host.combine_windows_host(wins, c, g2=g2))
    return out


def msm_pippenger(fops, points: JacPoint, scalars_plain, n_bits: int,
                  c: int | None = None, mesh=None) -> list:
    """MSM sum_i s_i * P_i via the windowed bucket method.

    points: JacPoint [L, n] (Montgomery limb form). scalars_plain: plain
    16-bit limbs [L, n] for one MSM or [L, k, n] for k scalar sets over the
    shared table. mesh: shard the points over its devices (see
    msm_pippenger_device). Returns k host affine points (None = identity)."""
    k = int(scalars_plain.shape[1]) if scalars_plain.dim() == 3 else 1
    pending = msm_pippenger_device(fops, points, scalars_plain, n_bits, c,
                                   mesh)
    return msm_to_host_affine(fops, pending, k)

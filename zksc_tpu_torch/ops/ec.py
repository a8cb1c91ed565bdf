"""Batched elliptic-curve ops over BN254 in PyTorch (plain tensor code).

The same formulas as the JAX package's ``ops/ec.py``, so Jacobian outputs
match limb for limb:

  - Points in Jacobian coordinates as limb tensors (see fields/limb.py),
    identity encoded as Z == 0. Formulas are branch-free: all cases
    computed, results selected with ``torch.where``.
  - Generic over the coordinate field via a small "field ops" adapter so
    the same formulas serve G1 (Fp) and G2 (Fp2 = Fp[i]/(i^2+1)).
  - G2 keeps the lane-folded layout: one tensor [L, 2N] per coordinate with
    c0 in the first N lanes and c1 in the last N.

These are the plain versions: the bucket MSM's point additions on a CUDA
tensor go through the hand-written kernels of ``ops/ec_kernels.py``. The
double-and-add ladders (msm_double_and_add, scale_points) call the ladder
kernel's wrapper, ``ops/msm_kernels.py:ladder``, which takes the plain
ladder (_batch_scale) on a CPU tensor.

Curve: BN254 y^2 = x^3 + 3 (a=0), G2 twist y^2 = x^3 + 3/(9+i).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..fields.limb import LimbField, Fp


class FpOps:
    """Field-ops adapter over the base field (element = int32[L, *batch])."""

    def __init__(self, F: LimbField):
        self.F = F

    def mul(self, a, b): return self.F.mont_mul(a, b)
    def add(self, a, b): return self.F.add(a, b)
    def sub(self, a, b): return self.F.sub(a, b)
    def neg(self, a): return self.F.neg(a)

    def mul_many(self, pairs):
        """k independent products as ONE field multiply over a stacked
        axis (fewer, wider ops)."""
        A = torch.stack([p[0] for p in pairs], dim=1)
        B = torch.stack([p[1] for p in pairs], dim=1)
        R = self.F.mont_mul(A, B)
        return [R[:, i] for i in range(len(pairs))]

    def select(self, cond, a, b):
        return torch.where(cond.unsqueeze(0), a, b)

    def is_zero(self, a): return self.F.is_zero(a)

    def zeros_like(self, a): return torch.zeros_like(a)

    def lane_width(self, a) -> int:
        return a.shape[-1]

    def lane_map(self, fn, a):
        """Apply a lane-axis transform to the raw storage. For Fp the
        storage IS the logical lane layout."""
        return fn(a)


class Fp2Ops:
    """Fp2 = Fp[i]/(i^2+1); element = ONE tensor [L, 2N]: c0 in the first N
    lanes, c1 in the last N (the JAX package's folded layout)."""

    def __init__(self, F: LimbField):
        self.F = F

    @staticmethod
    def _halves(a):
        n = a.shape[-1] // 2
        return a[..., :n], a[..., n:]

    def mul(self, a, b):
        return self.mul_many([(a, b)])[0]

    def mul_many(self, pairs):
        """k Fp2 products as one width-3kN base multiply (lane-concatenated):
        t0 = a0 b0, t1 = a1 b1, t2 = (a0+a1)(b0+b1); c0 = t0 - t1,
        c1 = t2 - t0 - t1."""
        F = self.F
        n = pairs[0][0].shape[-1] // 2
        m = len(pairs) * n
        cat = lambda xs: torch.cat(xs, dim=-1)
        a0 = cat([a[..., :n] for (a, b) in pairs])
        a1 = cat([a[..., n:] for (a, b) in pairs])
        b0 = cat([b[..., :n] for (a, b) in pairs])
        b1 = cat([b[..., n:] for (a, b) in pairs])
        sums = F.add(cat([a0, b0]), cat([a1, b1]))
        R = F.mont_mul(cat([a0, a1, sums[..., :m]]),
                       cat([b0, b1, sums[..., m:]]))
        t0, t1, t2 = R[..., :m], R[..., m:2 * m], R[..., 2 * m:]
        d = F.sub(cat([t0, t2]), cat([t1, t0]))
        c0, c1 = d[..., :m], F.sub(d[..., m:], t1)
        return [cat([c0[..., i * n:(i + 1) * n], c1[..., i * n:(i + 1) * n]])
                for i in range(len(pairs))]

    def add(self, a, b):
        return self.F.add(a, b)

    def sub(self, a, b):
        return self.F.sub(a, b)

    def neg(self, a):
        return self.F.neg(a)

    def select(self, cond, a, b):
        """cond: one flag per logical lane, applied to both halves."""
        return torch.where(torch.cat([cond, cond], dim=-1).unsqueeze(0), a, b)

    def is_zero(self, a):
        z = self.F.is_zero(a)                  # [2N]
        n = z.shape[-1] // 2
        return z[..., :n] & z[..., n:]

    def zeros_like(self, a):
        return torch.zeros_like(a)

    def lane_width(self, a) -> int:
        """Logical lane count (points), not raw tensor width."""
        return a.shape[-1] // 2

    def lane_map(self, fn, a):
        """Apply a lane-axis transform per component half, keeping the
        [c0 | c1] folded layout."""
        a0, a1 = self._halves(a)
        return torch.cat([fn(a0), fn(a1)], dim=-1)


class JacPoint(NamedTuple):
    """Jacobian point; coordinates are limb tensors."""
    x: object
    y: object
    z: object


def jac_identity_batch(fops, batch: tuple, device=None):
    """Identity point batch (1, 1, 0); `batch` counts LOGICAL lanes."""
    F = fops.F
    one = F.broadcast_const(1, batch, device=device)
    if isinstance(fops, Fp2Ops):
        one = torch.cat([one, F.zeros(batch, device=device)], dim=-1)
    return JacPoint(one, one, torch.zeros_like(one))


def _sel(fops, c, a: JacPoint, b: JacPoint) -> JacPoint:
    return JacPoint(fops.select(c, a.x, b.x), fops.select(c, a.y, b.y),
                    fops.select(c, a.z, b.z))


def jac_double(fops, P: JacPoint) -> JacPoint:
    """2P, a=0 curve. Complete for the identity (Z=0 -> Z3=0)."""
    A, B, Z3 = fops.mul_many([(P.x, P.x), (P.y, P.y),
                              (fops.add(P.y, P.y), P.z)])
    xb = fops.add(P.x, B)
    E = fops.add(fops.add(A, A), A)
    C, t, F_ = fops.mul_many([(B, B), (xb, xb), (E, E)])
    D2 = fops.sub(fops.sub(t, A), C)
    D = fops.add(D2, D2)                      # 2((X+B)^2 - A - C)
    X3 = fops.sub(F_, fops.add(D, D))
    C2 = fops.add(C, C)
    C4 = fops.add(C2, C2)
    C8 = fops.add(C4, C4)
    (Y3a,) = fops.mul_many([(E, fops.sub(D, X3))])
    Y3 = fops.sub(Y3a, C8)
    return JacPoint(X3, Y3, Z3)


def _add_raw(fops, P: JacPoint, Q: JacPoint):
    Z1Z1, Z2Z2 = fops.mul_many([(P.z, P.z), (Q.z, Q.z)])
    U1, U2, T1, T2 = fops.mul_many([(P.x, Z2Z2), (Q.x, Z1Z1),
                                    (Q.z, Z2Z2), (P.z, Z1Z1)])
    S1, S2 = fops.mul_many([(P.y, T1), (Q.y, T2)])
    H = fops.sub(U2, U1)
    r = fops.sub(S2, S1)
    HH, rr, Z1Z2 = fops.mul_many([(H, H), (r, r), (P.z, Q.z)])
    HHH, V, Z3 = fops.mul_many([(H, HH), (U1, HH), (Z1Z2, H)])
    X3 = fops.sub(fops.sub(rr, HHH), fops.add(V, V))
    Y3a, Y3b = fops.mul_many([(r, fops.sub(V, X3)), (S1, HHH)])
    Y3 = fops.sub(Y3a, Y3b)
    return JacPoint(X3, Y3, Z3), H, r


def jac_add(fops, P: JacPoint, Q: JacPoint) -> JacPoint:
    """P + Q, complete: handles P=O, Q=O, P=Q, P=-Q via selects."""
    raw, H, r = _add_raw(fops, P, Q)
    p_inf = fops.is_zero(P.z)
    q_inf = fops.is_zero(Q.z)
    same = fops.is_zero(H) & fops.is_zero(r)
    dbl = jac_double(fops, P)
    # P == Q -> double (P = -Q leaves Z3 = 0, the identity)
    res = _sel(fops, same & ~(p_inf | q_inf), dbl, raw)
    res = _sel(fops, p_inf, Q, res)
    return _sel(fops, q_inf, P, res)


def jac_add_incomplete(fops, P: JacPoint, Q: JacPoint) -> JacPoint:
    """P + Q handling the identity cases but NOT P == Q (gives (0, 0, 0)
    there instead of 2P); see the JAX package's ops/ec.py for when that is
    safe."""
    raw, _, _ = _add_raw(fops, P, Q)
    res = _sel(fops, fops.is_zero(P.z), Q, raw)
    return _sel(fops, fops.is_zero(Q.z), P, res)


def scalars_to_bits(F: LimbField, scalars_plain, n_bits: int):
    """Non-Montgomery scalar limbs [L, N] -> bits int32[n_bits, N],
    little-endian bit order."""
    s = scalars_plain.to(torch.int64)
    return torch.stack([(s[k // 16] >> (k % 16)) & 1
                        for k in range(n_bits)]).to(torch.int32)


# double-and-add ladders ----------------------------------------------------

def _segment_reduce(fops, pts: JacPoint, seg: int) -> JacPoint:
    """Sum of each length-`seg` run of lanes -> JacPoint [L, N/seg].

    The additions and their order are those of the JAX package's
    _segment_reduce_fori (log2(seg) rounds of pts + roll(pts, -stride),
    segment sums read at lanes j*seg), _tree_reduce_fori and
    _tree_reduce_rolled (seg = N): in each round lane t < stride of a
    segment adds lane t + stride, which is the halving tree written here."""
    assert seg & (seg - 1) == 0
    while seg > 1:
        half = seg // 2

        def part(lo):
            return lambda a: a.reshape(a.shape[0], -1, seg)[
                :, :, lo:lo + half].reshape(a.shape[0], -1)
        pts = jac_add(fops, JacPoint(*(fops.lane_map(part(0), c) for c in pts)),
                      JacPoint(*(fops.lane_map(part(half), c) for c in pts)))
        seg = half
    return pts


def jac_tree_reduce(fops, pts: JacPoint) -> JacPoint:
    """Reduce a batch of points to one by pairwise addition (log2 N batched
    adds). N must be a power of two (pad with identity)."""
    n = fops.lane_width(pts.x)
    assert n & (n - 1) == 0, "pad batch to a power of two"
    return _segment_reduce(fops, pts, n)


def _tile(fops, P: JacPoint, k: int) -> JacPoint:
    return JacPoint(*(fops.lane_map(lambda a: a.repeat(1, k), c) for c in P))


def msm_double_and_add(fops, points: JacPoint, scalar_bits,
                       n_bits: int) -> JacPoint:
    """Batched MSM sum_i s_i * P_i over a shared point table.

    points: JacPoint over m lanes (m a power of two). scalar_bits: int
    [n_bits, m] for a single MSM (returns a width-1 point) or [n_bits, k, m]
    for k independent scalar sets (returns a width-k point; the proof axis
    is folded into the lane axis). The ladder and the per-segment reduction
    are K3 (ops/msm_kernels.py:ladder). Its complete addition gives the
    reference's incomplete _msm_step result for every scalar below the group
    order: acc never equals +-P_i where the bit is set."""
    from . import msm_kernels
    bits3 = scalar_bits[:, None, :] if scalar_bits.dim() == 2 else scalar_bits
    k, m = int(bits3.shape[1]), fops.lane_width(points.x)
    bits2 = bits3.reshape(bits3.shape[0], k * m)
    pts = _tile(fops, points, k) if k > 1 else points
    return msm_kernels.ladder(fops, pts, bits2.to(torch.int32).contiguous(),
                              n_bits, seg=m)


def _batch_scale(fops, pts: JacPoint, n_bits: int, bits) -> JacPoint:
    """acc_i = s_i * P_i over every lane (no reduction): MSB-first
    double-and-add with the complete addition, the loop body of the JAX
    package's _batch_scale_jit and of pallas_msm._ladder_tile_kernel.
    bits: int [n_bits] (one scalar shared by every lane) or [n_bits, N],
    LSB first."""
    n = fops.lane_width(pts.x)
    acc = jac_identity_batch(fops, (n,), device=pts.x.device)
    for k in range(n_bits - 1, -1, -1):
        acc = jac_double(fops, acc)
        summed = jac_add(fops, acc, pts)
        acc = _sel(fops, (bits[k] != 0).expand(n), summed, acc)
    return acc


def scale_points(fops, pts: JacPoint, scalar: int, n_bits: int = 254) -> JacPoint:
    """Multiply EVERY lane of a point batch by the same host-known scalar
    (the ceremony's rerandomisation of h_query and c_query): K3 unreduced,
    with one shared bit vector."""
    from . import msm_kernels
    assert 0 <= scalar < (1 << n_bits), "scalar exceeds the ladder width"
    bits = torch.tensor([(scalar >> i) & 1 for i in range(n_bits)],
                        dtype=torch.int32, device=pts.x.device)
    return msm_kernels.ladder(fops, pts, bits, n_bits)


# host-side helpers --------------------------------------------------------

def g1_points_to_device(F: LimbField, pts: list, device=None) -> JacPoint:
    """Host affine G1 points (int tuples / None) -> JacPoint, Z = 1 (the
    identity as (0, 1, 0))."""
    xs, ys, zs = [], [], []
    for p in pts:
        if p is None:
            xs.append(0); ys.append(1); zs.append(0)
        else:
            xs.append(p[0]); ys.append(p[1]); zs.append(1)
    return JacPoint(F.to_device(xs, device=device),
                    F.to_device(ys, device=device),
                    F.to_device(zs, device=device))


def g2_points_to_device(F: LimbField, pts: list, device=None) -> JacPoint:
    """Host affine G2 points -> folded JacPoint ([L, 2N], c0 | c1)."""
    xs0, xs1, ys0, ys1, zs0 = [], [], [], [], []
    for p in pts:
        if p is None:
            xs0.append(0); xs1.append(0); ys0.append(1); ys1.append(0); zs0.append(0)
        else:
            xs0.append(p[0][0]); xs1.append(p[0][1])
            ys0.append(p[1][0]); ys1.append(p[1][1]); zs0.append(1)
    zeros = [0] * len(pts)
    return JacPoint(F.to_device(xs0 + xs1, device=device),
                    F.to_device(ys0 + ys1, device=device),
                    F.to_device(zs0 + zeros, device=device))


def g1_jac_to_host_affine(F: LimbField, pt: JacPoint, p_mod: int) -> list:
    """Jacobian G1 tensors -> host affine int tuples (None for identity)."""
    xs = F.from_device(pt.x)
    ys = F.from_device(pt.y)
    zs = F.from_device(pt.z)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, p_mod)
        zi2 = zi * zi % p_mod
        out.append((x * zi2 % p_mod, y * zi2 * zi % p_mod))
    return out


def g2_jac_to_host_affine(F: LimbField, pt: JacPoint, p_mod: int) -> list:
    from ..curve.bn254_host import f2_inv, f2_mul

    def halves(a):
        n = a.shape[-1] // 2
        return F.from_device(a[..., :n]), F.from_device(a[..., n:])
    x0, x1 = halves(pt.x)
    y0, y1 = halves(pt.y)
    z0, z1 = halves(pt.z)
    out = []
    for i in range(len(x0)):
        if z0[i] == 0 and z1[i] == 0:
            out.append(None)
            continue
        zi = f2_inv((z0[i], z1[i]))
        zi2 = f2_mul(zi, zi)
        out.append((f2_mul((x0[i], x1[i]), zi2),
                    f2_mul((y0[i], y1[i]), f2_mul(zi2, zi))))
    return out


G1_OPS = FpOps(Fp)
G2_OPS = Fp2Ops(Fp)

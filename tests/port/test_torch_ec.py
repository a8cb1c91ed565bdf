"""Port vs reference: Jacobian point formulas and the plain versions of the
two point-add kernels (K1 chunk_scan, K2 jac_add_n), G1 and G2, exact limb
equality with the JAX package.

Points are real query points of the committed artifacts/chacha20-1block
proving key, with crafted lanes for every case of the complete addition
(P = O, Q = O, P = Q, P = Q in another Jacobian representative, P = -Q,
P = Q = O). On the CPU the kernel wrappers take their plain PyTorch
versions; the kernels themselves are held to those on the card by
chip_smoke.py.

K1 is compared with zksc_tpu.ops.msm._local_scan for G1 (the XLA path,
which that function documents as limb-identical to the Pallas kernel). For
G2 that scan costs 42-44 s of XLA:CPU compile per flag
(tools/time_jax_oracles.py local_scan), so G2 is compared with
the Pallas kernel's own loop body (pallas_ec._scan_kernel: one ec.jac_add
per step from the identity) run with the JAX package's eager ops."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksc_tpu.ops import ec as jec
from zksc_tpu.ops import msm as jmsm
from zksc_tpu_torch.fields.limb import BN254_P as P_MOD
from zksc_tpu_torch.fields.limb import ints_to_limb_array, limb_array_to_ints
from zksc_tpu_torch.ops import ec as tec
from zksc_tpu_torch.ops import ec_kernels

PK = os.path.join(os.path.dirname(__file__), "..", "..", "artifacts",
                  "chacha20-1block", "pk.npz")
S, C = 16, 4


def _ints(a: np.ndarray) -> list:
    return limb_array_to_ints(np.asarray(a))


def _arr(vals: list) -> np.ndarray:
    return ints_to_limb_array(vals, 16)


@pytest.fixture(scope="module")
def raw_points():
    """Montgomery coordinate ints: G1 from a_query, G2 (c0, c1) from the
    folded b2 query; the first 64 lanes of each that are not the identity
    (the key's points are affine: Z = Montgomery one)."""
    with np.load(PK) as d:
        live = np.flatnonzero((d["a_z"] != 0).any(0))[:64]
        g1 = [_ints(d["a_" + k][:, live]) for k in "xyz"]
        n2 = d["b2_x"].shape[1] // 2
        z2 = d["b2_z"]
        live2 = np.flatnonzero((z2[:, :n2] != 0).any(0)
                               | (z2[:, n2:] != 0).any(0))[:64]
        g2 = [list(zip(_ints(d["b2_" + k][:, live2]),
                       _ints(d["b2_" + k][:, n2 + live2]))) for k in "xyz"]
    return g1, g2


def _neg(v):
    return (P_MOD - v) % P_MOD if isinstance(v, int) else tuple(_neg(c) for c in v)


def _scale(v, k):
    return v * k % P_MOD if isinstance(v, int) else tuple(c * k % P_MOD for c in v)


def _ident(g2):
    one = (1 << 256) % P_MOD
    return (one, one, 0) if not g2 else ((one, 0), (one, 0), (0, 0))


def _pack(lanes: list, g2: bool) -> list:
    """[(x, y, z)] per lane -> three numpy limb arrays (G2 folded)."""
    out = []
    for c in range(3):
        vals = [ln[c] for ln in lanes]
        if g2:
            vals = [v[0] for v in vals] + [v[1] for v in vals]
        out.append(_arr(vals))
    return out


def _edge_batches(g1, g2, use_g2):
    """Two 4-lane (P, Q) batches covering every addition case."""
    coords = g2 if use_g2 else g1
    pt = lambda i: tuple(coords[c][i] for c in range(3))
    I = _ident(use_g2)
    p = [pt(i) for i in range(8)]
    lam = 0x1234567890ABCDEF1234567
    rescaled = (_scale(p[5][0], lam * lam), _scale(p[5][1], lam ** 3),
                _scale(p[5][2], lam))
    batch_a = [(I, p[0]), (p[1], I), (p[2], p[2]),
               (p[3], (p[3][0], _neg(p[3][1]), p[3][2]))]
    batch_b = [(p[4], p[6]), (p[5], rescaled), (I, I), (p[7], p[0])]
    out = []
    for batch in (batch_a, batch_b):
        out.append((_pack([b[0] for b in batch], use_g2),
                    _pack([b[1] for b in batch], use_g2)))
    return out


def _jops(g2):
    return jec.G2_OPS if g2 else jec.G1_OPS


def _tops(g2):
    return tec.G2_OPS if g2 else tec.G1_OPS


def _jp(arrs):
    return jec.JacPoint(*(jnp.asarray(np.asarray(a).astype(np.uint32))
                          for a in arrs))


def _tp(arrs):
    return tec.JacPoint(*(torch.from_numpy(np.asarray(a).astype(np.int32))
                          for a in arrs))


def _eq_pt(ref, got):
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64),
                                      g.numpy().astype(np.int64))


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_point_formulas(raw_points, g2):
    for Pa, Qa in _edge_batches(*raw_points, g2):
        jo, to = _jops(g2), _tops(g2)
        P, Q = _jp(Pa), _jp(Qa)
        tP, tQ = _tp(Pa), _tp(Qa)
        _eq_pt(jec.jac_double(jo, P), tec.jac_double(to, tP))
        _eq_pt(jec.jac_add(jo, P, Q), tec.jac_add(to, tP, tQ))
        _eq_pt(jec.jac_add_incomplete(jo, P, Q),
               tec.jac_add_incomplete(to, tP, tQ))


@pytest.mark.parametrize("complete", [True, False])
@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_jac_add_n_plain(raw_points, g2, complete):
    """K2's CPU dispatch vs ec.jac_add / ec.jac_add_incomplete."""
    ref_fn = jec.jac_add if complete else jec.jac_add_incomplete
    for Pa, Qa in _edge_batches(*raw_points, g2):
        got = ec_kernels.jac_add_n(_tops(g2), _tp(Pa), _tp(Qa), complete)
        assert all(a.dtype == torch.int32 for a in got)
        _eq_pt(ref_fn(_jops(g2), _jp(Pa), _jp(Qa)), got)


def _scan_input(raw_points, g2):
    """C*S = 64 position-major lanes (lane = chunk*S + step) with crafted
    steps: chunk 0 adds a point to itself (the doubling case), chunk 1 its
    negation (back to O), chunk 2 holds identities, chunk 3 is as loaded."""
    coords = raw_points[1] if g2 else raw_points[0]
    lanes = [tuple(coords[c][i] for c in range(3)) for i in range(S * C)]
    I = _ident(g2)
    lanes[1] = lanes[0]
    lanes[S + 1] = (lanes[S][0], _neg(lanes[S][1]), lanes[S][2])
    for t in (0, 3, 4, 9, 15):
        lanes[2 * S + t] = I
    return _pack(lanes, g2)


def _reference_scan(g2, pts_np, inclusive):
    """(scanned position-major JacPoint, chunk totals) from the JAX package."""
    jo = _jops(g2)
    if not g2:
        return jmsm._local_scan(jo, _jp(pts_np), S, inclusive)
    # G2: the Pallas kernel body, pallas_ec._scan_kernel, on eager ops
    half = lambda a: (a[:, :C * S], a[:, C * S:])
    steps = [_jp([np.concatenate([h[:, s::S] for h in half(a)], axis=-1)
                  for a in pts_np]) for s in range(S)]
    acc = jec.jac_identity_batch(jo, (C,))
    outs = []
    for s in range(S):
        summed = jec.jac_add(jo, acc, steps[s])
        outs.append(summed if inclusive else acc)
        acc = summed

    def position_major(c):
        stacked = np.stack([np.asarray(o[c]) for o in outs])   # [S, L, 2C]
        halves = [stacked[..., :C], stacked[..., C:]]
        return np.concatenate(
            [h.transpose(1, 2, 0).reshape(16, C * S) for h in halves], axis=-1)
    return jec.JacPoint(*(position_major(c) for c in range(3))), acc


def _relayout(a, g2, src, dst):
    """Lanes of each component between position-major (chunk * S + step)
    and the step-major layout K1 works on (step * C + chunk)."""
    shape = {"pm": (16, C, S), "sm": (16, S, C)}
    halves = [a[:, :C * S], a[:, C * S:]] if g2 else [a]
    return torch.cat([h.reshape(shape[src]).transpose(1, 2).reshape(16, C * S)
                      for h in halves], dim=-1)


@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_chunk_scan_plain(raw_points, g2, inclusive):
    """K1's CPU dispatch (S = 16, C = 4) on the step-major layout the MSM's
    scan holds (lane = step * C + chunk) vs the JAX package's scan, whose
    position-major lanes are reordered for the comparison."""
    pts_np = _scan_input(raw_points, g2)
    ref_out, ref_tot = _reference_scan(g2, pts_np, inclusive)
    pts = tec.JacPoint(*(_relayout(a, g2, "pm", "sm") for a in _tp(pts_np)))
    ys, carry = ec_kernels.chunk_scan(_tops(g2), pts, S, inclusive)
    assert all(y.shape == (16, (2 if g2 else 1) * C * S) for y in ys)
    _eq_pt(ref_out, [_relayout(y, g2, "sm", "pm") for y in ys])
    _eq_pt(ref_tot, carry)


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_jac_add_n_views(raw_points, g2):
    """K2's CPU dispatch on the views the halving reduce passes (the two
    halves of one array; G2 as [16, 2, n] views of the folded layout)
    equals the call on dense copies, limb for limb."""
    from zksc_tpu_torch.ops import msm
    Pa, Qa = _edge_batches(*raw_points, g2)[0]
    n = 4
    if g2:
        whole = [np.concatenate([p[:, :n], q[:, :n], p[:, n:], q[:, n:]], -1)
                 for p, q in zip(Pa, Qa)]
    else:
        whole = [np.concatenate([p, q], -1) for p, q in zip(Pa, Qa)]
    W = _tp(whole)
    fo = _tops(g2)
    lo, hi = msm._lane_range(fo, W, 0, n), msm._lane_range(fo, W, n, 2 * n)
    assert not lo.x.is_contiguous() and not hi.x.is_contiguous()
    for complete in (True, False):
        got = ec_kernels.jac_add_n(fo, lo, hi, complete)
        want = ec_kernels.jac_add_n(fo, _tp(Pa), _tp(Qa), complete)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def _add_model(F, P, Q, complete: bool, g2: bool):
    """The kernels' point add (csrc/bn254.cuh jac_add) written with the
    port's Fp ops on Python-level lanes: the identity cases first, the
    11-product sequence where Q.z is Montgomery one (Z2Z2 = 1, U1 = X1,
    S1 = Y1, Z1 Z2 = Z1), the doubling where H = r = 0 (complete), and Fp2
    products as the two threads of a lane pair compute them, the schoolbook
    c0 = a0 b0 - a1 b1, c1 = a0 b1 + a1 b0. Each lane is one element of a
    width-1 tensor; returns the result lanes and the count of affine adds."""
    one = F.to_device([1])

    def mul(a, b):
        if not g2:
            return F.mont_mul(a, b)
        return (F.sub(F.mont_mul(a[0], b[0]), F.mont_mul(a[1], b[1])),
                F.add(F.mont_mul(a[0], b[1]), F.mont_mul(a[1], b[0])))

    def lift(op):
        return (lambda a, b: op(a, b)) if not g2 else \
            (lambda a, b: (op(a[0], b[0]), op(a[1], b[1])))
    add, sub = lift(F.add), lift(F.sub)

    def is_zero(a):
        return bool(F.is_zero(a).all()) if not g2 else \
            bool(F.is_zero(a[0]).all() and F.is_zero(a[1]).all())

    def is_one(a):
        return bool(torch.equal(a, one)) if not g2 else \
            bool(torch.equal(a[0], one) and F.is_zero(a[1]).all())

    def double(X, Y, Z):
        A, B = mul(X, X), mul(Y, Y)
        Z3 = mul(add(Y, Y), Z)
        E = add(add(A, A), A)
        C, t, Fq = mul(B, B), mul(add(X, B), add(X, B)), mul(E, E)
        D2 = sub(sub(t, A), C)
        D = add(D2, D2)
        X3 = sub(Fq, add(D, D))
        C2 = add(C, C)
        C8 = add(add(C2, C2), add(C2, C2))
        return X3, sub(mul(E, sub(D, X3)), C8), Z3

    (X1, Y1, Z1), (X2, Y2, Z2) = P, Q
    if is_zero(Z2):
        return P, 0
    if is_zero(Z1):
        return Q, 0
    Z1Z1 = mul(Z1, Z1)
    U2 = mul(X2, Z1Z1)
    S2 = mul(Y2, mul(Z1, Z1Z1))
    affine = is_one(Z2)
    if affine:
        U1, S1, Z1Z2 = X1, Y1, Z1
    else:
        Z2Z2 = mul(Z2, Z2)
        U1, S1, Z1Z2 = mul(X1, Z2Z2), mul(Y1, mul(Z2, Z2Z2)), mul(Z1, Z2)
    H, r = sub(U2, U1), sub(S2, S1)
    if complete and is_zero(H) and is_zero(r):
        return double(X1, Y1, Z1), int(affine)
    HH, rr = mul(H, H), mul(r, r)
    HHH, V = mul(H, HH), mul(U1, HH)
    X3 = sub(sub(rr, HHH), add(V, V))
    Y3 = sub(mul(r, sub(V, X3)), mul(S1, HHH))
    return (X3, Y3, mul(Z1Z2, H)), int(affine)


@pytest.mark.parametrize("complete", [True, False])
@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_kernel_add_model(raw_points, g2, complete):
    """The argument the kernels rely on, made executable: the affine-Q
    sequence and the schoolbook Fp2 split give the JAX package's
    ec.jac_add / jac_add_incomplete limbs on the crafted edge batches,
    with affine and Jacobian Q among them."""
    from zksc_tpu_torch.fields.limb import Fp as F
    ref_fn = jec.jac_add if complete else jec.jac_add_incomplete
    n_affine = 0
    for Pa, Qa in _edge_batches(*raw_points, g2):
        want = ref_fn(_jops(g2), _jp(Pa), _jp(Qa))
        tP, tQ = _tp(Pa), _tp(Qa)
        for i in range(4):
            def lane(pt):
                if not g2:
                    return tuple(a[:, i:i + 1] for a in pt)
                return tuple((a[:, i:i + 1], a[:, 4 + i:5 + i]) for a in pt)
            got, aff = _add_model(F, lane(tP), lane(tQ), complete, g2)
            n_affine += aff
            for c in range(3):
                ref = np.asarray(want[c]).astype(np.int64)
                exp = ref[:, i] if not g2 else np.stack([ref[:, i], ref[:, 4 + i]], -1)
                val = got[c][:, 0] if not g2 else torch.stack(
                    [got[c][0][:, 0], got[c][1][:, 0]], -1)
                np.testing.assert_array_equal(exp, val.numpy().astype(np.int64))
    assert n_affine >= 3          # the key's points are affine: the branch ran


def test_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor usable by the kernel is
    refused, not routed to the plain version."""
    P = tec.jac_identity_batch(tec.G1_OPS, (4,))
    meta = tec.JacPoint(*(a.to("meta") for a in P))
    with pytest.raises(ValueError):
        ec_kernels.jac_add_n(tec.G1_OPS, meta, meta, True)
    pts = tec.jac_identity_batch(tec.G1_OPS, (S * C,))
    with pytest.raises(ValueError):
        ec_kernels.chunk_scan(tec.G1_OPS,
                              tec.JacPoint(*(a.to("meta") for a in pts)), S, True)

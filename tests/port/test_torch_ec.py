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
    folded b2 query; 64 lanes each."""
    with np.load(PK) as d:
        g1 = [_ints(d["a_" + k][:, :64]) for k in "xyz"]
        n2 = d["b2_x"].shape[1] // 2
        g2 = [list(zip(_ints(d["b2_" + k][:, :64]),
                       _ints(d["b2_" + k][:, n2:n2 + 64]))) for k in "xyz"]
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


def _ts(a):
    """position-major [L, C*S] -> step-major [S, L, C]."""
    return a.reshape(16, C, S).permute(2, 0, 1).contiguous()


def _fs(a):
    return a.permute(1, 2, 0).reshape(16, C * S)


def _split_halves(arrs, g2):
    if not g2:
        return list(arrs)
    out = []
    for a in arrs:
        n = a.shape[-1] // 2
        out += [a[..., :n], a[..., n:]]
    return out


def _fold(arrs, g2):
    if not g2:
        return list(arrs)
    return [torch.cat([arrs[i], arrs[i + 1]], dim=-1) for i in (0, 2, 4)]


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


@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_chunk_scan_plain(raw_points, g2, inclusive):
    """K1's CPU dispatch (S = 16, C = 4) vs the JAX package's scan."""
    pts_np = _scan_input(raw_points, g2)
    ref_out, ref_tot = _reference_scan(g2, pts_np, inclusive)
    raws = _split_halves([torch.from_numpy(a.astype(np.int32))
                          for a in pts_np], g2)
    ys, carry = ec_kernels.chunk_scan(_tops(g2), [_ts(a) for a in raws], S,
                                      inclusive)
    assert all(y.shape == (S, 16, C) for y in ys)
    _eq_pt(ref_out, _fold([_fs(y) for y in ys], g2))
    _eq_pt(ref_tot, _fold(carry, g2))


def test_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor usable by the kernel is
    refused, not routed to the plain version."""
    P = tec.jac_identity_batch(tec.G1_OPS, (4,))
    meta = tec.JacPoint(*(a.to("meta") for a in P))
    with pytest.raises(ValueError):
        ec_kernels.jac_add_n(tec.G1_OPS, meta, meta, True)
    xs = [torch.zeros((S, 16, C), dtype=torch.int32, device="meta")] * 3
    with pytest.raises(ValueError):
        ec_kernels.chunk_scan(tec.G1_OPS, xs, S, True)

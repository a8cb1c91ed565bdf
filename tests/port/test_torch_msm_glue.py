"""Port vs reference: the plain versions of the bucket MSM's glue (K6,
zksc_tpu_torch/ops/msm_glue.py), which the CPU path runs and the kernels
are held to on the card.

- K6a's keys and histogram against the JAX package's scalars_to_digits,
  its key formula (zksc_tpu/ops/msm.py:_window_sums) and
  jax.ops.segment_sum.
- K6c's prefix sums (the kernel's order: runs, tiles of runs, tiles)
  against prefix sums in the JAX package's host arithmetic
  (zksc_tpu.curve.bn254_host), as affine points, with identity lanes and
  equal neighbours (P == Q in the adds).
- _window_sums through the glue's wrappers with _HS_MAX lowered, so that
  two K1 levels, the top and the bucket boundaries run, against the host
  oracle, G1 and G2.

Jacobian limbs may differ from the reference's (K6c adds in another
order), so points are compared as affine ints."""
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksc_tpu.curve import bn254_host as host
from zksc_tpu.fields.limb import Fp as JFp, Fr as JFr
from zksc_tpu.ops import ec as jec
from zksc_tpu.ops import msm as jmsm
from zksc_tpu_torch.fields.limb import Fr
from zksc_tpu_torch.ops import ec as tec
from zksc_tpu_torch.ops import msm, msm_glue

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

PK = os.path.join(os.path.dirname(__file__), "..", "..", "artifacts",
                  "chacha20-1block", "pk.npz")
N_PTS = 32


@pytest.fixture(scope="module")
def tables():
    """32 G1 and 32 G2 points of the committed key (lane 5 a copy of lane
    4, lane 9 the identity), as port tensors and host affine points."""
    with np.load(PK) as d:
        g1 = [d["a_" + k][:, :N_PTS].copy() for k in "xyz"]
        n2 = d["b2_x"].shape[1] // 2
        g2 = [np.concatenate([d["b2_" + k][:, :N_PTS],
                              d["b2_" + k][:, n2:n2 + N_PTS]], axis=-1)
              for k in "xyz"]
    for arrs, halves in ((g1, (0,)), (g2, (0, N_PTS))):
        for h in halves:
            for a in arrs:
                a[:, h + 5] = a[:, h + 4]
            arrs[2][:, h + 9] = 0
    out = {}
    for name, arrs, to_host in (
            ("G1", g1, jec.g1_jac_to_host_affine),
            ("G2", g2, jec.g2_jac_to_host_affine)):
        jp = jec.JacPoint(*(jnp.asarray(a.astype(np.uint32)) for a in arrs))
        tp = tec.JacPoint(*(torch.from_numpy(a.astype(np.int32)) for a in arrs))
        out[name] = (tp, to_host(JFp, jp, host.P))
    return out


def _fops(group):
    return tec.G2_OPS if group == "G2" else tec.G1_OPS


def _to_host(group, P):
    conv = tec.g2_jac_to_host_affine if group == "G2" else \
        tec.g1_jac_to_host_affine
    return conv(_fops(group).F, P, host.P)


def _add(group):
    return host.g2_add if group == "G2" else host.g1_add


def _scalars(n: int, n_bits: int, seed: int) -> list:
    """Mostly 0 / 1 (witness bits: equal digits, empty buckets) and some
    full-width values, with 0, 1 and 2^n_bits - 1."""
    rng = random.Random(seed)
    s = [rng.randrange(1 << n_bits) if rng.random() < 0.4 else
         rng.randrange(2) for _ in range(n)]
    s[0], s[1], s[2] = 0, 1, (1 << n_bits) - 1
    return s


@pytest.mark.parametrize("c,n,n_bits", [(4, 64, 16), (5, 40, 40),
                                        (13, 64, 254)])
def test_keys_plain_matches_reference(c, n, n_bits):
    """keys_plain (k = 2) equals the reference's keys (int32, segment-major,
    digit flipped) and jax.ops.segment_sum's counts."""
    k = 2
    W = -(-n_bits // c)
    rows = [_scalars(n, n_bits, 30 + j) for j in range(k)]
    sp = torch.stack([Fr.to_device(r, mont=False) for r in rows], dim=1)
    jsp = jnp.stack([JFr.to_device(r, mont=False) for r in rows], axis=1)
    digits = jnp.transpose(jmsm.scalars_to_digits(jsp, c, W), (1, 0, 2))
    two_c, segs = 1 << c, k * W
    f = (two_c - 1) - digits.astype(jnp.int32)
    seg_ids = jnp.arange(segs, dtype=jnp.int32).reshape(k, W, 1)
    want_key = (seg_ids * two_c + f).reshape(-1)
    want_counts = jax.ops.segment_sum(jnp.ones_like(want_key), want_key,
                                      num_segments=segs * two_c)
    key, counts = msm_glue.keys_plain(sp, c, W)
    assert key.dtype == torch.int32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want_key), key.numpy())
    np.testing.assert_array_equal(np.asarray(want_counts), counts.numpy())


def _scan_lanes(tables, group, T):
    """T lanes cycling over the 32 points with every third lane repeating
    its left neighbour (P == Q where they meet), plus the table's identity
    and duplicated lanes. Returns (port point, host points)."""
    tp, hpts = tables[group]
    idx = [i % N_PTS for i in range(T)]
    for i in range(2, T, 3):
        idx[i] = idx[i - 1]
    t = torch.tensor(idx)
    fops = _fops(group)
    return (tec.JacPoint(*(fops.lane_map(lambda a: a[:, t], c) for c in tp)),
            [hpts[i] for i in idx])


def _host_prefix(group, pts, inclusive):
    add, acc, out = _add(group), None, []
    for p in pts:
        nxt = add(acc, p)
        out.append(nxt if inclusive else acc)
        acc = nxt
    return out


@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("group", ["G1", "G2"])
def test_scan_top_plain_matches_host(tables, monkeypatch, group, inclusive):
    """scan_top_plain's prefix sums equal the host's: one tile (T = 37),
    several tiles of whole lanes (T = 300 over 3 tiles for G1, 5 for G2),
    and, with the tile cut to 8 threads, runs of several lanes over
    several tiles (T = 100)."""
    for T in (37, 300):
        X, hp = _scan_lanes(tables, group, T)
        got = _to_host(group, msm_glue.scan_top_plain(_fops(group), X,
                                                      inclusive))
        assert got == _host_prefix(group, hp, inclusive), T
    monkeypatch.setattr(msm_glue, "SCAN_THREADS", 8)
    P, m, B = msm_glue.scan_plan(100, group == "G2")
    assert m > 1 and B > 1
    X, hp = _scan_lanes(tables, group, 100)
    got = _to_host(group, msm_glue.scan_top_plain(_fops(group), X, inclusive))
    assert got == _host_prefix(group, hp, inclusive)


def test_scan_plan_fits_one_block():
    """scan_plan cuts any top (up to _HS_MAX lanes and beyond) into at most
    P tiles of P runs, covering every lane with no empty tile."""
    for g2 in (False, True):
        for T in (1, 5, 127, 128, 129, 5120, 8192, 16384, 16385, 70000):
            P, m, B = msm_glue.scan_plan(T, g2)
            assert P == msm_glue.SCAN_THREADS // (2 if g2 else 1)
            assert 1 <= B <= P and B * P * m >= T > (B - 1) * P * m, (g2, T)
            if T <= P * P:
                assert m == 1


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_window_sums_through_glue_match_host(tables, monkeypatch, group):
    """_window_sums of two proofs' 40-bit scalars at c = 5 (16 segments, N
    = 512) with _HS_MAX = 1: the sorted gather, an inclusive and an
    exclusive K1 level, the top scan over 2 lanes and the boundaries; each
    (proof, window) sum equals sum_i d_i P_i in host arithmetic. Then at
    _HS_MAX = 512: the whole scan in the top (inclusive)."""
    fops = _fops(group)
    tp, hpts = tables[group]
    c, n_bits, k = 5, 40, 2
    W = -(-n_bits // c)
    rows = [_scalars(N_PTS, n_bits, 40 + j) for j in range(k)]
    sp = torch.stack([Fr.to_device(r, mont=False) for r in rows], dim=1)
    digits = msm.scalars_to_digits(sp, c, W).permute(1, 0, 2)
    add, mul = (host.g2_add, host.g2_mul) if group == "G2" else \
        (host.g1_add, host.g1_mul)
    want = []
    for j in range(k):
        for w in range(W):
            acc = None
            for p, d in zip(hpts, digits[j, w].tolist()):
                if p is not None and d:
                    acc = add(acc, mul(p, d))
            want.append(acc)
    calls = []
    orig = msm_glue.bucket_boundaries

    def spy(fo, levels, cum, c_, n):
        calls.append(len(levels))
        return orig(fo, levels, cum, c_, n)
    monkeypatch.setattr(msm_glue, "bucket_boundaries", spy)
    for hs_max, n_levels in ((1, 3), (512, 1)):
        monkeypatch.setattr(msm, "_HS_MAX", hs_max)
        got = _to_host(group, msm._window_sums(fops, tp, sp, c, W))
        assert got == want, hs_max
        assert calls.pop() == n_levels

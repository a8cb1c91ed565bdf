"""Port vs reference: the bucket MSM (zksc_tpu_torch.ops.msm) on 32 points,
G1 with 40-bit and 254-bit scalars, G2 with 40-bit scalars, and one case
with the Hillis-Steele threshold lowered so the hierarchical chunk-scan
levels run. On the CPU every point add takes the kernels' plain versions.

Results are compared as affine ints (the stable sort may change Jacobian
representatives, not points) with sum_i s_i * P_i computed by the JAX
package's host arithmetic (zksc_tpu.curve.bn254_host), the oracle the JAX
package's own tests/test_msm.py holds msm_pippenger to: the JAX
msm_pippenger had not finished compiling for 32 G1 points after 240 s, at
17 GB RSS (tools/time_jax_oracles.py msm), which this suite cannot afford.
The digit extraction, the scalar bits and the window choice are compared
with the JAX functions directly."""
import os
import random

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
from zksc_tpu_torch.ops import msm

PK = os.path.join(os.path.dirname(__file__), "..", "..", "artifacts",
                  "chacha20-1block", "pk.npz")
N_PTS = 32


@pytest.fixture(scope="module")
def tables():
    """32 G1 points (a_query) and 32 G2 points (b2 query) of the committed
    key, as port tensors and as host affine points (the identity and a
    duplicated point included)."""
    with np.load(PK) as d:
        g1 = [d["a_" + k][:, :N_PTS].copy() for k in "xyz"]
        n2 = d["b2_x"].shape[1] // 2
        g2 = [np.concatenate([d["b2_" + k][:, :N_PTS],
                              d["b2_" + k][:, n2:n2 + N_PTS]], axis=-1)
              for k in "xyz"]
    for a in g1:
        a[:, 5] = a[:, 4]                       # a duplicated point
    g1[2][:, 9] = 0                             # an identity lane
    out = {}
    for name, arrs, to_host in (
            ("G1", g1, jec.g1_jac_to_host_affine),
            ("G2", g2, jec.g2_jac_to_host_affine)):
        jp = jec.JacPoint(*(jnp.asarray(a.astype(np.uint32)) for a in arrs))
        tp = tec.JacPoint(*(torch.from_numpy(a.astype(np.int32)) for a in arrs))
        out[name] = (tp, to_host(JFp, jp, host.P))
    return out


def _scalars(n_bits: int, seed: int) -> list:
    rng = random.Random(seed)
    s = [rng.randrange(1 << n_bits) for _ in range(N_PTS)]
    s[0], s[1], s[2] = 0, 1, (1 << n_bits) - 1
    return s


def _host_msm(points: list, scalars: list, g2: bool):
    add, mul = (host.g2_add, host.g2_mul) if g2 else (host.g1_add, host.g1_mul)
    acc = None
    for p, s in zip(points, scalars):
        if p is not None and s % host.R:
            acc = add(acc, mul(p, s))
    return acc


@pytest.mark.parametrize("group,n_bits", [("G1", 40), ("G1", 254),
                                          ("G2", 40)])
def test_msm_vs_host(tables, group, n_bits):
    g2 = group == "G2"
    tp, hpts = tables[group]
    rows = [_scalars(n_bits, 11), _scalars(n_bits, 12)]
    sp = torch.stack([Fr.to_device(r, mont=False) for r in rows], dim=1)
    fops = tec.G2_OPS if g2 else tec.G1_OPS
    pending = msm.msm_pippenger_device(fops, tp, sp, n_bits)
    got = msm.msm_to_host_affine(fops, pending, 2)
    assert got == [_host_msm(hpts, r, g2) for r in rows]


def test_msm_hierarchical_levels(tables, monkeypatch):
    """c = 5 gives 8 windows x 32 points = 256 scan lanes: with _HS_MAX = 8
    the scan runs an inclusive chunk level (C = 16), an exclusive one
    (C = 1) and the Hillis-Steele top, with the boundary corrections."""
    monkeypatch.setattr(msm, "_HS_MAX", 8)
    calls = []
    orig = msm._local_scan

    def local_scan(fops, pts, S, inclusive, carry_steps=1):
        calls.append(inclusive)
        return orig(fops, pts, S, inclusive, carry_steps)

    monkeypatch.setattr(msm, "_local_scan", local_scan)
    tp, hpts = tables["G1"]
    s = _scalars(40, 13)
    got = msm.msm_pippenger(tec.G1_OPS, tp, Fr.to_device(s, mont=False), 40,
                            c=5)
    assert calls == [True, False]
    assert got == [_host_msm(hpts, s, False)]


@pytest.mark.parametrize("c,n_bits", [(10, 40), (13, 254), (6, 40), (5, 40)])
def test_digits_bits_and_window_choice(c, n_bits):
    s = _scalars(n_bits, 14)
    W = -(-n_bits // c)
    ref = jmsm.scalars_to_digits(JFr.to_device(s, mont=False), c, W)
    got = msm.scalars_to_digits(Fr.to_device(s, mont=False), c, W)
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  got.numpy())
    ref_bits = jec.scalars_to_bits(JFr, JFr.to_device(s, mont=False), n_bits)
    got_bits = tec.scalars_to_bits(Fr, Fr.to_device(s, mont=False), n_bits)
    np.testing.assert_array_equal(np.asarray(ref_bits).astype(np.int64),
                                  got_bits.numpy())
    for n in (32, 1 << 16, 20 * (1 << 16)):
        assert msm.default_window_bits(n_bits, n) == \
            jmsm.default_window_bits(n_bits, n)


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_window_sums_in_place(tables, group, monkeypatch):
    """_window_sums with the halving reduce reading the two halves of the
    bucket array in place (views, no copy): every (proof, window) sum
    equals sum_i d_i * P_i over that window's digits, computed with the
    JAX package's host arithmetic (zksc_tpu.curve.bn254_host)."""
    from zksc_tpu_torch.ops import ec_kernels
    g2 = group == "G2"
    fops = tec.G2_OPS if g2 else tec.G1_OPS
    tp, hpts = tables[group]
    contiguous = []
    orig = ec_kernels.jac_add_n

    def spy(fo, P, Q, complete=True):
        contiguous.append(P.x.is_contiguous() and Q.x.is_contiguous())
        return orig(fo, P, Q, complete)

    monkeypatch.setattr(ec_kernels, "jac_add_n", spy)
    c, n_bits, k = 4, 12, 2
    W = -(-n_bits // c)
    rows = [_scalars(n_bits, 21), _scalars(n_bits, 22)]
    sp = torch.stack([Fr.to_device(r, mont=False) for r in rows], dim=1)
    digits = msm.scalars_to_digits(sp, c, W).permute(1, 0, 2)     # [k, W, n]
    sums = msm._window_sums(fops, tp, sp, c, W)
    conv = tec.g2_jac_to_host_affine if g2 else tec.g1_jac_to_host_affine
    got = conv(fops.F, sums, host.P)
    add, mul = (host.g2_add, host.g2_mul) if g2 else (host.g1_add, host.g1_mul)
    for j in range(k):
        for w in range(W):
            want = None
            for p, d in zip(hpts, digits[j, w].tolist()):
                if p is not None and d:
                    want = add(want, mul(p, d))
            assert got[j * W + w] == want, (j, w)
    assert False in contiguous        # the reduce handed K2 views

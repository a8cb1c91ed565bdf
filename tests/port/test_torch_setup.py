"""Port vs reference: the trusted setup (groth16/setup.py), the fixed-base
products it runs on (ops/msm.py:batch_scalar_mul_fixed_base), the key files
(groth16/artifacts.py:save_keys) and keygen's key store.

With random.Random(7) drawn in the order tau, alpha, beta, gamma, delta, the
port's setup of tests/test_ceremony.py's circuit (out == x^7 + 3) equals
the JAX package's point for point, limb for limb. The keys the port writes
are read back by the JAX package's load_keys into the same arrays. The
fixed-base products are compared with the JAX function at the widths the
JAX setup has just compiled (8 G1 lanes, 16 G2 lanes: a new 8-lane G2
width costs 30 s of XLA:CPU, tools/time_jax_oracles.py setup) and with host
scalar products for crafted scalars."""
import json
import os
import random

import numpy as np
import pytest

from zksc_tpu.curve import bn254_host as host
from zksc_tpu.groth16 import artifacts as jart
from zksc_tpu.groth16 import setup as jsetup
from zksc_tpu.ops import msm as jmsm
from zksc_tpu.r1cs import compile_circuit as j_compile
from zksc_tpu_torch import keygen
from zksc_tpu_torch.groth16 import artifacts as tart
from zksc_tpu_torch.groth16 import setup as tsetup
from zksc_tpu_torch.ops import msm as tmsm
from zksc_tpu_torch.r1cs import compile_circuit as t_compile

PUB, PRIV = [("out", 1)], [("x", 1)]
QUERIES = ("a_query", "b_g1_query", "b_g2_query", "c_query", "h_query")
POINTS = ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2")


def define(api, v):
    x = v["x"][0]
    out = v["out"][0]
    acc = x
    for _ in range(6):
        acc = api.mul(acc, x)
    api.assert_eq(api.add(acc, api.constant(3)), out)


def _rng():
    r = random.Random(7)
    return lambda: r.randrange(2, host.R)


def _port_keys():
    return tsetup(t_compile(define, PUB, PRIV), rng=_rng(), device="cpu")


def _eq_query(jq, tq):
    for j, t in zip(jq, tq):
        np.testing.assert_array_equal(np.asarray(j).astype(np.int64),
                                      t.numpy().astype(np.int64))


def test_setup_matches_jax_and_keys_cross_load(tmp_path):
    jcs = j_compile(define, PUB, PRIV)
    jpk, jvk = jsetup(jcs, rng=_rng())
    pk, vk = _port_keys()
    assert pk.digest == jpk.digest == jcs.digest()
    for f in ("n_public", "n_wires", "domain_n", *POINTS):
        assert getattr(pk, f) == getattr(jpk, f), f
    for q in QUERIES:
        _eq_query(getattr(jpk, q), getattr(pk, q))
    assert (vk.alpha_g1, vk.beta_g2, vk.gamma_g2, vk.delta_g2, vk.ic) == \
        (jvk.alpha_g1, jvk.beta_g2, jvk.gamma_g2, jvk.delta_g2, jvk.ic)

    # fixed-base products at the widths the JAX setup compiled
    rs = np.random.RandomState(11)
    sc = [0, 1, host.R - 1] + [int(rs.randint(1, 2**62)) * int(rs.randint(1, 2**62))
                               for _ in range(13)]
    assert tmsm.batch_scalar_mul_fixed_base(sc[:8], host.G1_GEN, device="cpu") \
        == jmsm.batch_scalar_mul_fixed_base(sc[:8], host.G1_GEN)
    assert tmsm.batch_scalar_mul_fixed_base(sc, host.G2_GEN, g2=True,
                                            device="cpu") \
        == jmsm.batch_scalar_mul_fixed_base(sc, host.G2_GEN, g2=True)

    # the port's files, read by the JAX package
    tart.save_keys(str(tmp_path), pk, vk)
    jpk2, jvk2 = jart.load_keys(str(tmp_path), expected_digest=jcs.digest())
    for q in QUERIES:
        _eq_query(getattr(jpk2, q), getattr(pk, q))
        assert np.asarray(getattr(jpk2, q).x).dtype == np.uint32
    for f in POINTS:
        assert getattr(jpk2, f) == getattr(pk, f)
    assert jvk2.ic == vk.ic and jvk2.delta_g2 == vk.delta_g2


def test_fixed_base_matches_host():
    rs = np.random.RandomState(12)
    sc = [0, 1, 2, host.R - 1, (host.R - 1) // 2] + \
        [int(rs.randint(1, 2**62)) << 190 | int(rs.randint(0, 2**62))
         for _ in range(3)]
    for g2, gen, mul in ((False, host.G1_GEN, host.g1_mul),
                         (True, host.G2_GEN, host.g2_mul)):
        got = tmsm.batch_scalar_mul_fixed_base(sc, gen, g2=g2, device="cpu")
        assert got == [mul(gen, s) if s % host.R else None for s in sc]


def test_save_load_roundtrip(tmp_path):
    pk, vk = _port_keys()
    tart.save_keys(str(tmp_path), pk, vk)
    pk2, vk2 = tart.load_keys(str(tmp_path), expected_digest=pk.digest,
                              device="cpu")
    for q in QUERIES:
        for a, b in zip(getattr(pk, q), getattr(pk2, q)):
            assert a.dtype == b.dtype and bool((a == b).all())
    assert vk2 == vk
    with open(tmp_path / "pk_meta.json") as f:
        assert json.load(f)["digest"] == pk.digest
    with pytest.raises(ValueError, match="digest"):
        tart.load_keys(str(tmp_path), expected_digest="0" * 64, device="cpu")


def test_keygen_store_is_not_the_committed_tree():
    root = os.path.dirname(os.path.dirname(os.path.abspath(keygen.__file__)))
    store = os.path.abspath(keygen.KEY_STORE)
    assert store.startswith(os.path.join(root, "zksc_tpu_torch", "build") + os.sep)
    assert not store.startswith(os.path.join(root, "artifacts"))
    a, b = keygen.seeded_rng(3), keygen.seeded_rng(3)
    assert [a() for _ in range(5)] == [b() for _ in range(5)]


def test_new_entry_points_refuse_without_cuda(monkeypatch, tmp_path):
    import torch

    from zksc_tpu_torch import api
    from zksc_tpu_torch.operators import Groth16Operator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsetup(t_compile(define, PUB, PRIV))
    with pytest.raises(RuntimeError, match="CUDA"):
        keygen.main(["--algorithm", "aes-128-ctr", "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())
    with pytest.raises(RuntimeError, match="CUDA"):
        Groth16Operator("aes-256-ctr")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.generate_proof("aes-128-ctr", bytes(16), bytes(80), bytes(12))

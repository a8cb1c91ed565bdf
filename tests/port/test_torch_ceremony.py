"""Port vs reference: the phase-2 ceremony (groth16/ceremony.py).

On the port's key for tests/test_ceremony.py's circuit (out == x^7 + 3,
setup with random.Random(7), held equal to the JAX package's key by
test_torch_setup.py), a chain of one contribution with a fixed scalar, one
contribute() and a final beacon: the chain verifies, tampering with any
link is rejected, the queries are checked scaled, and a proof made by the
port with the final key is accepted by the JAX package's verifier (the
port's verifier too) and a proof with the initial key is not.
_apply_delta against the JAX package's: test_torch_apply_delta.py."""
import copy
import random

import pytest

from zksc_tpu.curve import bn254_host as host
from zksc_tpu.groth16 import verify as jverify
from zksc_tpu.groth16.prove import Proof as JProof
from zksc_tpu.groth16.setup import VerifyingKey as JVerifyingKey
from zksc_tpu_torch.groth16 import ProverContext, setup, verify
from zksc_tpu_torch.groth16.ceremony import (
    _apply_delta, apply_beacon, contribute, verify_chain,
    verify_query_scaling,
)
from zksc_tpu_torch.ops import ec
from zksc_tpu_torch.r1cs import compile_circuit, generate_witness

PUB, PRIV = [("out", 1)], [("x", 1)]
D1 = 0x1D5B_7A11_C0DE_2024_0917_F00D_BEEF


def define(api, v):
    x = v["x"][0]
    out = v["out"][0]
    acc = x
    for _ in range(6):
        acc = api.mul(acc, x)
    api.assert_eq(api.add(acc, api.constant(3)), out)


@pytest.fixture(scope="module")
def chain():
    cs = compile_circuit(define, PUB, PRIV)
    srng = random.Random(7)
    pk0, vk0 = setup(cs, rng=lambda: srng.randrange(2, host.R), device="cpu")
    pk1, vk1, c1 = _apply_delta(pk0, vk0, D1, "", "contribution", "")
    pk2, vk2, c2 = contribute(pk1, vk1, entropy=b"second",
                              prev_transcript=c1.transcript)
    pk3, vk3, c3 = apply_beacon(pk2, vk2, "00aa11bb", n_iters=4,
                                prev_transcript=c2.transcript)
    return cs, (pk0, vk0), (pk3, vk3), [c1, c2, c3]


def test_chain_verifies_and_rejects_tampering(chain):
    _, (pk0, _), _, cons = chain
    d1, d2 = pk0.delta_g1, pk0.delta_g2
    assert verify_chain(d1, d2, cons, check_beacon_last=True)
    assert not verify_chain(d1, d2, cons[:2], check_beacon_last=True)
    bad = copy.copy(cons[1])
    bad.d_g2 = host.g2_mul(host.G2_GEN, 12345)
    bad.transcript = bad.chain_hash(cons[0].transcript)
    assert not verify_chain(d1, d2, [cons[0], bad])
    assert not verify_chain(d1, d2, [cons[0], cons[2]])       # splice
    idc = copy.copy(cons[1])
    idc.d_g1 = idc.d_g2 = idc.delta_g1_after = idc.delta_g2_after = None
    idc.transcript = idc.chain_hash(cons[0].transcript)
    assert not verify_chain(d1, d2, [cons[0], idc])
    beacon = copy.copy(cons[2])
    beacon.beacon = "deadbeef:4"
    beacon.transcript = beacon.chain_hash(cons[1].transcript)
    assert not verify_chain(d1, d2, [cons[0], cons[1], beacon])


def test_query_scaling_check(chain):
    _, (pk0, _), (pk3, _), _ = chain
    rng = random.Random(13)
    draw = lambda: rng.randrange(1, host.R)
    for q in ("h_query", "c_query"):
        assert verify_query_scaling(getattr(pk0, q), getattr(pk3, q),
                                    pk0.delta_g2, pk3.delta_g2, 8, rng=draw)
    forged = ec.scale_points(ec.G1_OPS, pk0.h_query, 99991, n_bits=17)
    assert not verify_query_scaling(pk0.h_query, forged, pk0.delta_g2,
                                    pk3.delta_g2, 8, rng=draw)


def test_proof_after_ceremony_accepted_by_jax_verify(chain):
    cs, (pk0, vk0), (pk3, vk3), _ = chain
    x = 4
    out = (pow(x, 7, host.R) + 3) % host.R
    w = generate_witness(define, PUB, PRIV, {"out": [[out]]}, {"x": [[x]]},
                         batch=1)[:, 0]
    p3 = ProverContext(cs, pk3, device="cpu").prove(w)
    jvk3 = JVerifyingKey(vk3.alpha_g1, vk3.beta_g2, vk3.gamma_g2,
                         vk3.delta_g2, vk3.ic, vk3.digest)
    assert jverify(jvk3, JProof(p3.a, p3.b, p3.c), [out])
    assert verify(vk3, p3, [out])
    assert not jverify(jvk3, JProof(p3.a, p3.b, p3.c), [out + 1])
    # the initial key's proofs verify under the initial vk only
    p0 = ProverContext(cs, pk0, device="cpu").prove(w)
    assert verify(vk0, p0, [out])
    assert not jverify(jvk3, JProof(p0.a, p0.b, p0.c), [out])

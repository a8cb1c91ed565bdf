"""Port vs reference: the ceremony's key update (groth16/ceremony.py:
_apply_delta) with a fixed scalar d gives h_query and c_query limb for limb
equal to the JAX package's _apply_delta (both rescale every lane by 1/d with
a 254-bit double-and-add ladder: ops/ec.py:scale_points, the JAX
_batch_scale_jit), and the same deltas and contribution record."""
import random

import jax.numpy as jnp
import numpy as np

from zksc_tpu.curve import bn254_host as host
from zksc_tpu.groth16 import ceremony as jcer
from zksc_tpu.groth16.setup import ProvingKey as JProvingKey
from zksc_tpu.groth16.setup import VerifyingKey as JVerifyingKey
from zksc_tpu.ops.ec import JacPoint as JJacPoint
from zksc_tpu_torch.groth16 import ceremony as tcer
from zksc_tpu_torch.groth16 import setup
from zksc_tpu_torch.r1cs import compile_circuit

PUB, PRIV = [("out", 1)], [("x", 1)]
QUERIES = ("a_query", "b_g1_query", "b_g2_query", "c_query", "h_query")
D = 0x2A_5EED_0F_C0FFEE_1234_5678_9ABC_DEF0


def define(api, v):
    x = v["x"][0]
    out = v["out"][0]
    acc = x
    for _ in range(6):
        acc = api.mul(acc, x)
    api.assert_eq(api.add(acc, api.constant(3)), out)


def _to_jax(pk, vk):
    q = {name: JJacPoint(*(jnp.asarray(a.numpy().astype(np.uint32))
                           for a in getattr(pk, name))) for name in QUERIES}
    jpk = JProvingKey(n_public=pk.n_public, n_wires=pk.n_wires,
                      domain_n=pk.domain_n, delta_g1=pk.delta_g1,
                      beta_g1=pk.beta_g1, alpha_g1=pk.alpha_g1,
                      beta_g2=pk.beta_g2, delta_g2=pk.delta_g2,
                      digest=pk.digest, **q)
    jvk = JVerifyingKey(vk.alpha_g1, vk.beta_g2, vk.gamma_g2, vk.delta_g2,
                        vk.ic, vk.digest)
    return jpk, jvk


def test_apply_delta_matches_jax():
    srng = random.Random(7)
    pk, vk = setup(compile_circuit(define, PUB, PRIV),
                   rng=lambda: srng.randrange(2, host.R), device="cpu")
    jpk, jvk = _to_jax(pk, vk)
    args = (D, "ab" * 32, "contribution", "")
    pk1, vk1, con = tcer._apply_delta(pk, vk, *args)
    jpk1, jvk1, jcon = jcer._apply_delta(jpk, jvk, *args)
    for name in QUERIES:
        for j, t in zip(getattr(jpk1, name), getattr(pk1, name)):
            np.testing.assert_array_equal(np.asarray(j).astype(np.int64),
                                          t.numpy().astype(np.int64))
    assert (pk1.delta_g1, pk1.delta_g2, vk1.delta_g2) == \
        (jpk1.delta_g1, jpk1.delta_g2, jvk1.delta_g2)
    assert (con.d_g1, con.d_g2, con.transcript, con.kind) == \
        (jcon.d_g1, jcon.d_g2, jcon.transcript, jcon.kind)

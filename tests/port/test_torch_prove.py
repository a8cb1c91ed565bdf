"""Port vs reference: Groth16 proving.

Toy circuit (out == x^13 + x + 41, plus an 8-bit decomposition): the JAX
package's setup() makes the key under a fixed random.Random seed, the key
goes through proving_key_from_numpy, and the port proves on the CPU with a
fixed blinding rng: its m_pad of 32 takes the double-and-add ladder branch
with B2 on the host, as the JAX prover does, and with force_pippenger the
bucket MSMs give the very same proof. The proof must equal, exactly, the
Groth16 proof that
the JAX prover's algorithm defines for these inputs (groth16/prove.py:
prove_batch): its five MSMs and the quotient h recomputed here with the JAX
package's host arithmetic and plain polynomial algebra, combined with the
same blinding. (Running zksc_tpu's ProverContext.prove itself costs ~153 s
for this circuit on top of the 56 s setup, 94 s of it compiling the vmapped
H program — tools/time_jax_oracles.py prove — more than this file may
take.) The JAX verifier accepts the port's proof and the
port's verifier accepts the expected one; a tampered public input is
rejected by both.

chacha20, host side only: the port's circuit digest equals the committed
key's, its witness equals the JAX package's for a fixed chunk, and
load_keys returns the committed arrays unchanged."""
import json
import os
import random

import numpy as np
import pytest
import torch

from zksc_tpu import api as japi
from zksc_tpu import operators as jops
from zksc_tpu.curve import bn254_host as host
from zksc_tpu.groth16 import setup as jsetup, verify as jverify
from zksc_tpu.r1cs import compile_circuit as j_compile
from zksc_tpu.r1cs import generate_witness as j_witness
from zksc_tpu_torch import api as tapi
from zksc_tpu_torch import operators as tops
from zksc_tpu_torch.groth16 import ProverContext, verify as tverify
from zksc_tpu_torch.groth16.artifacts import load_keys, proving_key_from_numpy
from zksc_tpu_torch.ops.ntt import bit_reverse_perm
from zksc_tpu_torch.r1cs import compile_circuit as t_compile
from zksc_tpu_torch.r1cs import generate_witness as t_witness

ART = os.path.join(os.path.dirname(__file__), "..", "..", "artifacts")
PUB, PRIV = [("out", 1)], [("x", 1)]
X = 7
OUT = (pow(X, 13, host.R) + X + 41) % host.R


def define(api, v):
    x = v["x"][0]
    out = v["out"][0]
    acc = x
    for _ in range(12):
        acc = api.mul(acc, x)
    api.assert_eq(api.add(acc, x, api.constant(41)), out)
    bits = api.to_bits(api.add(x, api.constant(2)), 8)
    api.assert_eq(api.from_bits(bits), api.add(x, api.constant(2)))


def _jax_key_arrays(pk) -> tuple:
    arrays = {}
    for name, q in (("a", pk.a_query), ("b1", pk.b_g1_query),
                    ("b2", pk.b_g2_query), ("c", pk.c_query),
                    ("h", pk.h_query)):
        for c in "xyz":
            arrays[f"{name}_{c}"] = np.asarray(getattr(q, c))
    meta = {k: getattr(pk, k) for k in (
        "n_public", "n_wires", "domain_n", "alpha_g1", "beta_g1", "delta_g1",
        "beta_g2", "delta_g2", "digest")}
    return arrays, meta


@pytest.fixture(scope="module")
def toy():
    jcs = j_compile(define, PUB, PRIV)
    srng = random.Random(23)
    jpk, jvk = jsetup(jcs, rng=lambda: srng.randrange(2, host.R))
    wit = t_witness(define, PUB, PRIV, {"out": [[OUT]]}, {"x": [[X]]},
                    batch=1)[:, 0]
    return jcs, jpk, jvk, wit


def _blinding():
    r = random.Random(5)
    return lambda: r.randrange(1, host.R)


def _quotient(cs, z, n):
    """h = (A B - C) / (x^n - 1) coefficients, from the constraint rows
    evaluated at the domain points (plain O(n^2) interpolation)."""
    R = host.R
    from zksc_tpu_torch.ops.ntt import find_2adic_root
    from zksc_tpu_torch.fields.limb import Fr
    w = find_2adic_root(Fr, n)
    w_inv, n_inv = pow(w, -1, R), pow(n, -1, R)
    polys = []
    for sel in range(3):
        ev = [sum(c * z[k] for k, c in lcs[sel].items()) % R
              for lcs in cs.constraints] + [0] * (n - cs.n_constraints)
        polys.append([n_inv * sum(ev[k] * pow(w_inv, j * k, R)
                                  for k in range(n)) % R for j in range(n)])
    a, b, c = polys
    p = [0] * (2 * n - 1)
    for i in range(n):
        for j in range(n):
            p[i + j] = (p[i + j] + a[i] * b[j]) % R
    for i in range(n):
        p[i] = (p[i] - c[i]) % R
    q = [0] * n
    for i in range(2 * n - 2, n - 1, -1):
        q[i - n] = p[i]
        p[i - n] = (p[i - n] + p[i]) % R
        p[i] = 0
    assert not any(p), "A*B - C does not vanish on the domain"
    return q


def _expected_proof(jpk, cs, wit, rng):
    """The proof of zksc_tpu's ProverContext.prove_batch for this witness,
    from host MSMs over the key's points."""
    from zksc_tpu.fields.limb import Fp
    from zksc_tpu.ops import ec as jec
    g = host
    z = [int(v) % g.R for v in wit]
    g1 = lambda q: jec.g1_jac_to_host_affine(Fp, q, g.P)
    a_q, b1_q, c_q, h_q = (g1(q) for q in (jpk.a_query, jpk.b_g1_query,
                                           jpk.c_query, jpk.h_query))
    b2_q = jec.g2_jac_to_host_affine(Fp, jpk.b_g2_query, g.P)

    def msm(pts, sc, g2=False):
        add, mul = (g.g2_add, g.g2_mul) if g2 else (g.g1_add, g.g1_mul)
        acc = None
        for p, s in zip(pts, sc):
            if p is not None and s % g.R:
                acc = add(acc, mul(p, s))
        return acc

    ell = jpk.n_public + 1
    n = jpk.domain_n
    h = _quotient(cs, z, n)
    br = bit_reverse_perm(n)
    a_pt, b1_pt, b2_pt = msm(a_q, z), msm(b1_q, z), msm(b2_q, z, True)
    c_pt = msm(c_q, z[ell:])
    h_pt = msm(h_q, [h[int(br[i])] for i in range(n)])
    r_b, s_b = rng(), rng()
    A = g.g1_add(g.g1_add(jpk.alpha_g1, a_pt), g.g1_mul(jpk.delta_g1, r_b))
    B = g.g2_add(g.g2_add(jpk.beta_g2, b2_pt), g.g2_mul(jpk.delta_g2, s_b))
    B1 = g.g1_add(g.g1_add(jpk.beta_g1, b1_pt), g.g1_mul(jpk.delta_g1, s_b))
    C = g.g1_add(g.g1_add(c_pt, h_pt),
                 g.g1_add(g.g1_mul(A, s_b),
                          g.g1_add(g.g1_mul(B1, r_b),
                                   g.g1_mul(jpk.delta_g1,
                                            (-r_b * s_b) % g.R))))
    return A, B, C


def test_toy_circuit_and_witness_match(toy):
    jcs, _, _, wit = toy
    tcs = t_compile(define, PUB, PRIV)
    assert tcs.digest() == jcs.digest()
    jwit = j_witness(define, PUB, PRIV, {"out": [[OUT]]}, {"x": [[X]]},
                     batch=1)[:, 0]
    assert [int(v) for v in wit] == [int(v) for v in jwit]


def test_proof_equals_reference_and_cross_verifies(toy):
    jcs, jpk, jvk, wit = toy
    arrays, meta = _jax_key_arrays(jpk)
    pk = proving_key_from_numpy(arrays, meta, device="cpu")
    ctx = ProverContext(t_compile(define, PUB, PRIV), pk, device="cpu")
    proof = ctx.prove(wit, rng=_blinding())
    A, B, C = _expected_proof(jpk, jcs, wit, _blinding())
    assert (proof.a, proof.b, proof.c) == (A, B, C)
    # the JAX verifier accepts the port's proof; the port's accepts the
    # reference proof; both reject a wrong public input
    from zksc_tpu.groth16.prove import Proof as JProof
    from zksc_tpu_torch.groth16 import Proof as TProof
    assert jverify(jvk, JProof(proof.a, proof.b, proof.c), [OUT])
    assert tverify(jvk, TProof(A, B, C), [OUT])
    assert not jverify(jvk, JProof(proof.a, proof.b, proof.c), [OUT + 1])
    assert not tverify(jvk, proof, [OUT + 1])


def test_ladder_branch_equals_pippenger_branch(toy):
    jcs, jpk, jvk, wit = toy
    arrays, meta = _jax_key_arrays(jpk)
    pk = proving_key_from_numpy(arrays, meta, device="cpu")
    tcs = t_compile(define, PUB, PRIV)
    ladder = ProverContext(tcs, pk, device="cpu")
    pip = ProverContext(tcs, pk, device="cpu", force_pippenger=True)
    assert ladder.m_pad == 32 and not ladder.force_pippenger
    p1 = ladder.prove(wit, rng=_blinding())
    p2 = pip.prove(wit, rng=_blinding())
    # the ladder proof is held to the reference proof by the test above
    assert (p1.a, p1.b, p1.c) == (p2.a, p2.b, p2.c)
    # witness_to_device: the ladder's bits of the widest witness value
    z_mont, z_bits, nb = ladder.witness_to_device(wit)
    assert nb == 40 and tuple(z_bits.shape) == (40, 32)
    vals = [int(v) % host.R for v in wit] + [0] * (32 - len(wit))
    assert [sum(int(z_bits[k, i]) << k for k in range(40))
            for i in range(32)] == vals


def test_chacha20_digest_witness_and_keys():
    key, iv = bytes(range(32)), bytes(range(100, 112))
    ct = bytes((7 * i + 3) & 0xFF for i in range(128))
    spec = tops.CircuitSpec("chacha20")
    with open(os.path.join(ART, "chacha20", "pk_meta.json")) as f:
        assert spec.cs.digest() == json.load(f)["digest"]
    wi = tapi.generate_zk_witness("chacha20", key, ct, iv)
    jwi = japi.generate_zk_witness("chacha20", key, ct, iv)
    assert wi.plaintext == jwi.plaintext
    ref = jops.CircuitSpec("chacha20").build_witness(jwi)
    np.testing.assert_array_equal(np.asarray(spec.build_witness(wi)),
                                  np.asarray(ref))
    pk, vk = load_keys(os.path.join(ART, "chacha20"), spec.cs.digest(),
                       device="cpu")
    with np.load(os.path.join(ART, "chacha20", "pk.npz")) as d:
        for name, q in (("a", pk.a_query), ("b1", pk.b_g1_query),
                        ("c", pk.c_query), ("h", pk.h_query)):
            for c in "xyz":
                np.testing.assert_array_equal(
                    getattr(q, c).numpy(), d[f"{name}_{c}"].astype(np.int32))
        for c in "xyz":
            folded = np.concatenate([d[f"b2_{c}0"], d[f"b2_{c}1"]], axis=-1)
            np.testing.assert_array_equal(getattr(pk.b_g2_query, c).numpy(),
                                          folded.astype(np.int32))
    assert pk.domain_n == 1 << 16 and pk.n_wires == 45217
    assert pk.a_query.x.dtype == torch.int32
    assert len(vk.ic) == pk.n_public + 1 == 2305

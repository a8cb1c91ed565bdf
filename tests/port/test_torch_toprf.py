"""Port vs reference: the three TOPRF statements (chacha20-toprf,
aes-128-ctr-toprf, aes-256-ctr-toprf) under the Groth16 engine.

For each statement the port's circuit compiles to the digest of the
committed artifacts/<alg>/manifest.json and of the JAX package; a seeded
TOPRF round (keys, request, one share's evaluation, finalize: the circuit
checks THRESHOLD = 1 response, as the reference's toprf.go:16) gives a
witness equal to zksc_tpu.operators.CircuitSpec.build_witness element for
element, which satisfies the constraints; the verifier's public signals
equal the reference's and the witness's public wires. The committed
chacha20-toprf key loads into the port under the digest pin.

The slice as a whole, at toy size: a circuit of a few MiMC rounds (the
round of r1cs/circuits/toprf.py:mimc_sum) and a BabyJubJub addition (its
point_add), whose wires hold full-width field elements, proved by the port
on the CPU through the wide-witness branch of ProverContext and 254-bit
bucket MSMs. The proof equals the Groth16 proof that the JAX prover's
algorithm defines for these inputs, computed with the JAX package's host
arithmetic (curve/bn254_host.py) as tests/port/test_torch_prove.py does,
and both packages' verifiers accept it."""
import functools
import json
import os
import random

import numpy as np
import pytest

from zksc_tpu import api as japi
from zksc_tpu import operators as jops
from zksc_tpu.curve import bn254_host as jhost
from zksc_tpu.groth16 import verify as jverify
from zksc_tpu.groth16.prove import Proof as JProof
from zksc_tpu.oprf import oprf as joprf
from zksc_tpu.r1cs import generate_witness as j_witness
from zksc_tpu_torch import api as tapi
from zksc_tpu_torch import operators as tops
from zksc_tpu_torch.config import CONFIG
from zksc_tpu_torch.groth16 import ProverContext, setup as tsetup
from zksc_tpu_torch.groth16 import verify as tverify
from zksc_tpu_torch.groth16.artifacts import load_keys
from zksc_tpu_torch.ops import ec
from zksc_tpu_torch.ops.ntt import bit_reverse_perm, find_2adic_root
from zksc_tpu_torch.oprf import oprf
from zksc_tpu_torch.r1cs import check_witness, compile_circuit
from zksc_tpu_torch.r1cs import generate_witness
from zksc_tpu_torch.r1cs.circuits import toprf as toprf_gadget

ART = os.path.join(os.path.dirname(__file__), "..", "..", "artifacts")
ALGS = ["chacha20", "aes-128-ctr", "aes-256-ctr"]
DOMAIN = b"reclaim"
SPAN = {"chacha20": (17, 21), "aes-128-ctr": (5, 14), "aes-256-ctr": (33, 25)}


def _signals(pkg_api, pkg_oprf, plaintext, pos, length, seed=42,
             threshold=1, other_share=False):
    """One share's TOPRF round over plaintext[pos:pos+length] (the shape of
    tests/test_toprf_e2e.py), with the package's own protocol code. With
    other_share, the signals carry share 2's response beside share 1's
    output (the shares differ for threshold > 1)."""
    rng = random.Random(seed)
    r = lambda: rng.randrange(1, pkg_oprf.L)
    _, shares = pkg_oprf.generate_threshold_keys(n=2, threshold=threshold,
                                                 rng=r)
    req = pkg_oprf.generate_request(plaintext[pos:pos + length], rng=r,
                                    domain_separator=DOMAIN)
    share = shares[0]
    resp = pkg_oprf.evaluate(share.secret, req.masked_point, rng=r)
    out = pkg_oprf.threshold_finalize(req, {share.index: resp})
    if other_share:
        share = shares[1]
        resp = pkg_oprf.evaluate(share.secret, req.masked_point, rng=r)
    signals = pkg_api.ZKTOPRFPublicSignals(
        locations=[(pos, length)], domain_separator=DOMAIN, output=out,
        responses=[pkg_api.TOPRFResponseSignals(
            index=share.index, public_key=resp.public_key,
            evaluated=resp.evaluated, c=resp.dleq.c, r=resp.dleq.r)])
    return signals, req.mask


@functools.lru_cache(maxsize=None)
def _spec(name):
    """The port's CircuitSpec, compiled once per test process."""
    spec = tops.CircuitSpec(name)
    spec.cs
    return spec


def _chunk(alg):
    cfg = CONFIG[alg + "-toprf"]
    rng = random.Random(alg)
    key = bytes(rng.randrange(256) for _ in range(cfg.key_size_bytes))
    iv = bytes(rng.randrange(256) for _ in range(cfg.iv_size_bytes))
    pt = bytes(rng.randrange(256) for _ in range(cfg.chunk_size_bytes))
    ct = tapi._decrypt(alg, key, iv, cfg.start_counter, pt)
    return key, iv, pt, ct


@pytest.mark.parametrize("alg", ALGS)
def test_toprf_circuit_digest_equals_manifest_and_reference(alg):
    name = alg + "-toprf"
    cs = _spec(name).cs
    with open(os.path.join(ART, name, "manifest.json")) as f:
        man = json.load(f)
    assert (cs.digest(), cs.n_constraints, cs.n_wires, cs.n_public) == \
        (man["digest"], man["n_constraints"], man["n_wires"], man["n_public"])
    assert cs.digest() == jops.CircuitSpec(name).cs.digest()


@pytest.mark.parametrize("alg", ALGS)
def test_toprf_witness_and_public_signals_equal_reference(alg):
    key, iv, pt, ct = _chunk(alg)
    pos, length = SPAN[alg]
    sig, mask = _signals(tapi, oprf, pt, pos, length)
    jsig, jmask = _signals(japi, joprf, pt, pos, length)
    assert (sig.output, mask) == (jsig.output, jmask)
    wi = tapi.generate_zk_witness(alg, key, ct, iv, toprf=sig, mask=mask)
    jwi = japi.generate_zk_witness(alg, key, ct, iv, toprf=jsig, mask=jmask)
    assert wi.algorithm == jwi.algorithm == alg + "-toprf"
    assert wi.plaintext == pt
    spec = _spec(wi.algorithm)
    w = spec.build_witness(wi)
    jw = jops.CircuitSpec(jwi.algorithm).build_witness(jwi)
    assert w.shape == jw.shape
    assert [int(v) for v in w] == [int(v) for v in jw]
    assert check_witness(spec.cs, w[:, None])
    pub = tapi.get_public_signals_toprf(alg, ct, iv, sig)
    assert pub == japi.get_public_signals_toprf(alg, ct, iv, jsig)
    assert len(pub) == spec.cs.n_public
    assert [int(x) for x in w[1:1 + spec.cs.n_public]] == \
        [int(x) % oprf.bjj.Q for x in pub]


def test_chacha20_toprf_rejects_wrong_output_and_other_share():
    """tests/test_toprf_e2e.py:62-70: a witness whose public TOPRF output
    is off by one fails the constraints; so do the public signals of
    another share's response (keys of threshold 2, so the shares differ)."""
    key, iv, pt, ct = _chunk("chacha20")
    sig, mask = _signals(tapi, oprf, pt, 3, 40, threshold=2)
    wi = tapi.generate_zk_witness("chacha20", key, ct, iv, toprf=sig,
                                  mask=mask)
    spec = _spec(wi.algorithm)
    w = spec.build_witness(wi)
    assert check_witness(spec.cs, w[:, None])
    n_pub = spec.cs.n_public
    w2 = w.copy()
    w2[n_pub] = (int(w2[n_pub]) + 1) % (2**255)
    assert not check_witness(spec.cs, w2[:, None])
    other, _ = _signals(tapi, oprf, pt, 3, 40, threshold=2,
                        other_share=True)
    assert other.output == sig.output
    assert other.responses[0].evaluated != sig.responses[0].evaluated
    pub = tapi.get_public_signals_toprf("chacha20", ct, iv, other)
    w3 = w.copy()
    w3[1:1 + n_pub] = [int(x) % oprf.bjj.Q for x in pub]
    assert not check_witness(spec.cs, w3[:, None])


def test_committed_toprf_key_loads_on_cpu():
    name = "chacha20-toprf"
    cs = _spec(name).cs
    d = os.path.join(ART, name)
    pk, vk = load_keys(d, expected_digest=cs.digest(), device="cpu")
    assert pk.n_wires == cs.n_wires and pk.domain_n == 1 << 17
    assert len(vk.ic) == cs.n_public + 1
    with np.load(os.path.join(d, "pk.npz")) as data:
        np.testing.assert_array_equal(pk.a_query.x.numpy(),
                                      data["a_x"].astype(np.int32))
        np.testing.assert_array_equal(pk.h_query.z.numpy(),
                                      data["h_z"].astype(np.int32))
    with pytest.raises(ValueError, match="digest"):
        load_keys(d, expected_digest="0" * 64, device="cpu")
    op = tops.Groth16Operator(name, device="cpu")
    assert op._key_dir() == os.path.join(tops.ARTIFACT_ROOT, name)
    assert op.ensure_vk().ic == vk.ic


def test_toprf_witness_values_equal_reference():
    """The gadget's host helper for a proof's TOPRF inputs, replicated over
    a batch, under one seeded round per package (threshold-2 keys, share
    2's response: the circuit checks THRESHOLD = 1 response)."""
    from zksc_tpu.r1cs.circuits import toprf as jgadget

    def run(mod, gadget):
        rng = random.Random(5)
        r = lambda: rng.randrange(1, mod.L)
        _, shares = mod.generate_threshold_keys(3, 2, rng=r)
        req = mod.generate_request(b"secret", rng=r, domain_separator=DOMAIN)
        resps = {2: mod.evaluate(shares[1].secret, req.masked_point, rng=r)}
        out = mod.threshold_finalize(req, resps)
        return gadget.toprf_witness_values(DOMAIN, req, resps, [2], out,
                                           batch=3)

    pub, priv = run(oprf, toprf_gadget)
    assert (pub, priv) == run(joprf, jgadget)
    assert len(pub["toprf_resp"]) == 2 and len(pub["toprf_out"][0]) == 3
    assert pub["toprf_coeff"] == [[1, 1, 1]]
    assert toprf_gadget.TOPRF_PUBLIC_LAYOUT == jgadget.TOPRF_PUBLIC_LAYOUT
    assert toprf_gadget.TOPRF_PRIVATE_LAYOUT == jgadget.TOPRF_PRIVATE_LAYOUT


def test_toprf_argument_checks_equal_reference():
    key, iv, pt, ct = _chunk("chacha20")
    sig, mask = _signals(tapi, oprf, pt, 0, 8)
    for pkg in (tapi, japi):
        with pytest.raises(ValueError, match="toprf signals and a mask"):
            pkg.generate_zk_witness("chacha20-toprf", key, ct, iv, mask=mask)
        with pytest.raises(ValueError, match="toprf signals and a mask"):
            pkg.generate_zk_witness("chacha20-toprf", key, ct, iv, toprf=sig)
        # signals on the plain name select the -toprf statement
        wi = pkg.generate_zk_witness("chacha20", key, ct, iv, toprf=sig,
                                     mask=mask)
        assert (wi.algorithm, wi.mask) == ("chacha20-toprf", mask)
        # a mask alone leaves the plain statement
        assert pkg.generate_zk_witness("chacha20", key, ct, iv,
                                       mask=mask).algorithm == "chacha20"
    with pytest.raises(ValueError, match="toprf signals and a mask"):
        tapi.generate_proof("chacha20-toprf", key, ct, iv, mask=mask,
                            device="cpu")
    env = tapi.ProofEnvelope("chacha20-toprf", {}, b"", len(ct))
    assert tapi.verify_proof(env, ct, iv, device="cpu") is False
    assert japi.verify_proof(japi.ProofEnvelope("chacha20-toprf", {}, b"",
                                                len(ct)), ct, iv) is False
    names = set(tapi.PORTED_ALGORITHMS)
    assert names == set(CONFIG) == set(japi.CONFIG)


def test_algorithms_info_equals_reference(monkeypatch):
    """get_algorithms_info over a plain and a -toprf statement (the full
    table compiles all six circuits twice: ~30 s)."""
    names = ("chacha20", "chacha20-toprf")
    for mod in (tapi, japi):
        monkeypatch.setattr(mod, "CONFIG", {n: CONFIG[n] for n in names})
    info = tapi.get_algorithms_info()
    assert info == japi.get_algorithms_info()
    assert info["chacha20-toprf"]["domain_n"] == 1 << 17
    assert info["chacha20-toprf"]["n_wires"] == 91001


# ------------------------------------------------------------ toy proof

MIMC_ROUNDS = 12
PUB, PRIV = [("out", 1), ("px", 1), ("py", 1)], [("x", 1)]
P0 = oprf.bjj.mul(oprf.bjj.BASE, 987654321)


def toy_define(api, v):
    """out == MiMC-rounds(x) + (P + P).x with P = (px, py) on BabyJubJub."""
    h = v["x"][0]
    for c in toprf_gadget.MIMC_CONSTANTS[:MIMC_ROUNDS]:
        t = api.add(h, api.constant(c))
        t2 = api.mul(t, t)
        h = api.mul(api.mul(t2, t2), t)
    p = (v["px"][0], v["py"][0])
    toprf_gadget.assert_on_curve(api, p)
    d = toprf_gadget.point_add(api, p, p)
    api.assert_eq(api.add(h, d[0]), v["out"][0])


def _toy_values(x):
    Q = oprf.bjj.Q
    h = x
    for c in toprf_gadget.MIMC_CONSTANTS[:MIMC_ROUNDS]:
        h = pow((h + c) % Q, 5, Q)
    out = (h + oprf.bjj.add(P0, P0)[0]) % Q
    return {"out": [[out]], "px": [[P0[0]]], "py": [[P0[1]]]}, {"x": [[x]]}


def _quotient(cs, z, n):
    """h = (A B - C) / (x^n - 1) coefficients, from the constraint rows at
    the domain points (plain O(n^2) interpolation)."""
    from zksc_tpu_torch.fields.limb import Fr
    R = jhost.R
    w = find_2adic_root(Fr, n)
    w_inv, n_inv = pow(w, -1, R), pow(n, -1, R)
    pw = [pow(w_inv, k, R) for k in range(n)]
    polys = []
    for sel in range(3):
        ev = [sum(c * z[k] for k, c in lcs[sel].items()) % R
              for lcs in cs.constraints] + [0] * (n - cs.n_constraints)
        polys.append([n_inv * sum(ev[k] * pw[j * k % n] for k in range(n))
                      % R for j in range(n)])
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


def _expected_proof(pk, cs, wit, rng):
    """The proof that the JAX prover's prove_batch defines for this
    witness and key: its MSMs and blinding combine in the JAX package's
    host arithmetic over the key's points."""
    from zksc_tpu_torch.fields.limb import Fp
    g = jhost
    z = [int(v) % g.R for v in wit]
    g1 = lambda q: ec.g1_jac_to_host_affine(Fp, q, g.P)
    a_q, b1_q, c_q, h_q = (g1(q) for q in (pk.a_query, pk.b_g1_query,
                                           pk.c_query, pk.h_query))
    b2_q = ec.g2_jac_to_host_affine(Fp, pk.b_g2_query, g.P)

    def msm(pts, sc, g2=False):
        add, mul = (g.g2_add, g.g2_mul) if g2 else (g.g1_add, g.g1_mul)
        acc = None
        for p, s in zip(pts, sc):
            if p is not None and s % g.R:
                acc = add(acc, mul(p, s))
        return acc

    ell = pk.n_public + 1
    n = pk.domain_n
    h = _quotient(cs, z, n)
    br = bit_reverse_perm(n)
    a_pt, b1_pt, b2_pt = msm(a_q, z), msm(b1_q, z), msm(b2_q, z, True)
    c_pt = msm(c_q, z[ell:])
    h_pt = msm(h_q, [h[int(br[i])] for i in range(n)])
    r_b, s_b = rng(), rng()
    A = g.g1_add(g.g1_add(pk.alpha_g1, a_pt), g.g1_mul(pk.delta_g1, r_b))
    B = g.g2_add(g.g2_add(pk.beta_g2, b2_pt), g.g2_mul(pk.delta_g2, s_b))
    B1 = g.g1_add(g.g1_add(pk.beta_g1, b1_pt), g.g1_mul(pk.delta_g1, s_b))
    C = g.g1_add(g.g1_add(c_pt, h_pt),
                 g.g1_add(g.g1_mul(A, s_b),
                          g.g1_add(g.g1_mul(B1, r_b),
                                   g.g1_mul(pk.delta_g1, (-r_b * s_b) % g.R))))
    return A, B, C


def _blinding():
    r = random.Random(5)
    return lambda: r.randrange(1, jhost.R)


def test_wide_witness_toy_proof_equals_reference_and_cross_verifies():
    pub, priv = _toy_values(x=0x1234567890ABCDEF1234567890ABCDEF)
    cs = compile_circuit(toy_define, PUB, PRIV)
    wit = generate_witness(toy_define, PUB, PRIV, pub, priv, batch=1)[:, 0]
    jwit = j_witness(toy_define, PUB, PRIV, pub, priv, batch=1)[:, 0]
    assert [int(v) for v in wit] == [int(v) for v in jwit]
    assert check_witness(cs, wit[:, None])
    srng = random.Random(31)
    pk, vk = tsetup(cs, rng=lambda: srng.randrange(2, jhost.R), device="cpu")
    ctx = ProverContext(cs, pk, device="cpu", force_pippenger=True)
    _, _, nb = ctx.witness_to_device(wit)
    assert nb == 254
    proof = ctx.prove(wit, rng=_blinding())
    assert (proof.a, proof.b, proof.c) == \
        _expected_proof(pk, cs, wit, _blinding())
    public = [pub["out"][0][0], P0[0], P0[1]]
    assert tverify(vk, proof, public)
    assert jverify(vk, JProof(proof.a, proof.b, proof.c), public)
    bad = [public[0] + 1] + public[1:]
    assert not tverify(vk, proof, bad)
    assert not jverify(vk, JProof(proof.a, proof.b, proof.c), bad)

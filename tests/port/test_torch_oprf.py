"""Port vs reference: the threshold-OPRF host layer (utils/keccak.py,
oprf/{babyjubjub,mimc,oprf,locations,operator}.py).

Everything here is Python integers on the host, so every comparison is
exact: the same inputs, drawn from one random.Random seed per package, give
the same keccak digests, MiMC constants and hashes, BabyJubJub points,
requests, share evaluations, DLEQ (c, r), Lagrange coefficients, threshold
outputs, wire dicts and bitmasks in zksc_tpu_torch as in zksc_tpu. The MiMC
vectors are those of tests/test_oprf.py."""
import random

import pytest

from zksc_tpu.oprf import babyjubjub as jbjj
from zksc_tpu.oprf import locations as jloc
from zksc_tpu.oprf import mimc as jmimc
from zksc_tpu.oprf import oprf as joprf
from zksc_tpu.oprf import operator as jop
from zksc_tpu.utils.keccak import keccak256 as jkeccak
from zksc_tpu_torch.oprf import babyjubjub as bjj
from zksc_tpu_torch.oprf import locations as loc
from zksc_tpu_torch.oprf import mimc
from zksc_tpu_torch.oprf import oprf
from zksc_tpu_torch.oprf import operator as op
from zksc_tpu_torch.utils.keccak import keccak256

Q = mimc.Q


def _rng(seed, lo=1, hi=bjj.L_ORDER):
    r = random.Random(seed)
    return lambda: r.randrange(lo, hi)


@pytest.mark.parametrize("n", [0, 1, 4, 135, 136, 137, 272, 300])
def test_keccak256_equals_reference(n):
    data = bytes(random.Random(n).randrange(256) for _ in range(n))
    assert keccak256(data) == jkeccak(data)
    assert len(keccak256(data)) == 32


def test_mimc_constants_and_structure():
    """gnark-crypto parity invariants (tests/test_oprf.py vectors): 110
    keccak-chain constants, x^5 rounds, h' = E_h(m) + h + m."""
    assert mimc.N_ROUNDS == 110 and mimc.CONSTANTS == jmimc.CONSTANTS
    x = keccak256(keccak256(b"seed"))
    assert mimc.CONSTANTS[0] == int.from_bytes(x, "big") % Q
    assert mimc.CONSTANTS[1] == int.from_bytes(keccak256(x), "big") % Q
    m1, m2 = 123, 456
    h1 = (mimc.mimc_encrypt(m1, 0) + m1) % Q
    h2 = (mimc.mimc_encrypt(m2, h1) + h1 + m2) % Q
    assert mimc.mimc_hash([m1, m2]) == h2 == jmimc.mimc_hash([m1, m2])


def test_mimc_byte_semantics_equal_reference():
    assert mimc.mimc_hash_bytes(b"\x01") == mimc.mimc_hash([1])
    assert mimc.mimc_hash_bytes((2).to_bytes(32, "big"), b"\x03") == \
        mimc.mimc_hash([2, 3])
    assert mimc.mimc_hash_bytes(b"") == mimc.mimc_hash([0])
    with pytest.raises(ValueError):
        mimc.mimc_hash_bytes(Q.to_bytes(32, "big"))
    assert mimc.int_bytes(0) == b"" and mimc.int_bytes(256) == b"\x01\x00"
    rnd = random.Random(3)
    for n in (1, 31, 32, 33, 64, 95):
        chunk = bytes(rnd.randrange(256) for _ in range(n))
        if n % 32 == 0:
            chunk = b"\x00" + chunk[1:]          # a canonical block
        try:
            want = jmimc.mimc_hash_bytes(chunk, b"x")
        except ValueError:
            with pytest.raises(ValueError):
                mimc.mimc_hash_bytes(chunk, b"x")
            continue
        assert mimc.mimc_hash_bytes(chunk, b"x") == want
    long = bytes(range(40))
    assert oprf.split_secret_elements(long) == \
        joprf.split_secret_elements(long)
    assert oprf.split_secret_elements(b"\x01\x02") == [0x0201, 0]
    with pytest.raises(ValueError):
        oprf.split_secret_elements(bytes(63))


def test_babyjubjub_laws_and_reference():
    assert (bjj.Q, bjj.A, bjj.D, bjj.L_ORDER, bjj.BASE) == \
        (jbjj.Q, jbjj.A, jbjj.D, jbjj.L_ORDER, jbjj.BASE)
    p = bjj.mul(bjj.BASE, 12345)
    assert bjj.is_on_curve(p) and bjj.in_subgroup(p)
    assert bjj.add(p, bjj.neg(p)) == bjj.IDENTITY
    assert bjj.add(p, bjj.IDENTITY) == p
    assert bjj.mul(bjj.BASE, bjj.L_ORDER) == bjj.IDENTITY
    a, b = 777, 888
    assert bjj.add(bjj.mul(p, a), bjj.mul(p, b)) == bjj.mul(p, a + b)
    rnd = _rng(5)
    for _ in range(3):
        k, m = rnd(), rnd()
        q = bjj.mul(bjj.BASE, k)
        assert q == jbjj.mul(jbjj.BASE, k)
        assert bjj.add(q, bjj.mul(q, m)) == jbjj.add(q, jbjj.mul(q, m))
        assert bjj.clear_cofactor(q) == jbjj.clear_cofactor(q)


def _protocol(mod, seed):
    """One threshold round (n=3, t=2) under one rng: keys, a request,
    evaluations by shares 1 and 3, the threshold output and the
    single-share output of share 1."""
    rng = _rng(seed)
    master_pub, shares = mod.generate_threshold_keys(3, 2, rng)
    req = mod.generate_request(b"user@example.com", rng,
                               domain_separator=b"reclaim")
    resps = {s.index: mod.evaluate(s.secret, req.masked_point, rng)
             for s in (shares[0], shares[2])}
    out = mod.threshold_finalize(req, resps, server_public=master_pub)
    single = mod.threshold_finalize(req, {1: resps[1]})
    coeffs = [mod.lagrange_coeff([1, 3], i) for i in (1, 3)]
    return master_pub, shares, req, resps, out, single, coeffs


def test_threshold_protocol_equals_reference():
    t = _protocol(oprf, 11)
    j = _protocol(joprf, 11)
    master_pub, shares, req, resps, out, single, coeffs = t
    assert master_pub == j[0]
    assert [(s.index, s.secret, s.public_key) for s in shares] == \
        [(s.index, s.secret, s.public_key) for s in j[1]]
    assert (req.mask, req.masked_point, req.secret_elements) == \
        (j[2].mask, j[2].masked_point, j[2].secret_elements)
    for i in (1, 3):
        a, b = resps[i], j[3][i]
        assert (a.evaluated, a.public_key, a.dleq.c, a.dleq.r) == \
            (b.evaluated, b.public_key, b.dleq.c, b.dleq.r)
    assert (out, single, coeffs) == (j[4], j[5], j[6])
    # any two shares give the master key's output; one share its own
    sk = sum(c * shares[i - 1].secret for c, i in zip(coeffs, (1, 3))) \
        % bjj.L_ORDER
    assert bjj.mul(bjj.BASE, sk) == master_pub
    assert out == oprf.finalize(req, oprf.evaluate(sk, req.masked_point,
                                                   _rng(12)))
    assert single != out


def test_dleq_and_bad_dleq_rejected():
    rng = _rng(21)
    sk = rng()
    H = bjj.mul(bjj.BASE, rng())
    xG, xH = bjj.mul(bjj.BASE, sk), bjj.mul(H, sk)
    proof = oprf.dleq_prove(sk, H, _rng(22))
    jproof = joprf.dleq_prove(sk, H, _rng(22))
    assert (proof.c, proof.r) == (jproof.c, jproof.r)
    assert oprf.dleq_verify(proof, xG, xH, H)
    assert not oprf.dleq_verify(proof, xG, bjj.mul(H, sk + 1), H)
    req = oprf.generate_request(b"x", rng)
    resp = oprf.evaluate(sk, req.masked_point, rng)
    resp.dleq.r = (resp.dleq.r + 1) % bjj.L_ORDER
    with pytest.raises(ValueError, match="DLEQ"):
        oprf.finalize(req, resp)
    with pytest.raises(ValueError, match="small subgroup"):
        oprf.evaluate(sk, bjj.IDENTITY)


def _wire_round(mod, seed):
    o = mod.make_oprf_operator(rng=_rng(seed, 2, 2**250))
    keys = o.generate_threshold_keys(3, 2)
    request = o.generate_oprf_request_data(b"someone@mail.test", "reclaim")
    responses = []
    for s in keys["shares"][:2]:
        r = o.evaluate_oprf(s["privateKey"], request["maskedData"])
        r["index"] = s["index"]
        r["publicKeyShare"] = s["publicKey"]
        responses.append(r)
    out = o.finalise_oprf(keys["publicKey"], request, responses)
    return o, keys, request, responses, out


def test_oprf_operator_wire_equals_reference():
    o, keys, request, responses, out = _wire_round(op, 7)
    _, jkeys, jrequest, jresponses, jout = _wire_round(jop, 7)
    assert (keys, request, responses, out) == \
        (jkeys, jrequest, jresponses, jout)
    for s in keys["shares"]:
        raw = op._unb64(s["publicKey"])
        assert op.point_to_bytes(op.point_from_bytes(raw)) == raw
        assert op.point_from_bytes(raw) == jop.point_from_bytes(raw)
    assert op.scalar_to_bytes(0) == b"\x00" == jop.scalar_to_bytes(0)


@pytest.mark.parametrize("tamper", ["c", "evaluated", "server key", "point"])
def test_oprf_operator_rejects_tampering(tamper):
    o, keys, request, responses, _ = _wire_round(op, 8)
    responses = [dict(r) for r in responses]
    server = keys["publicKey"]
    if tamper == "c":
        c = int.from_bytes(op._unb64(responses[0]["c"]), "big") + 1
        responses[0]["c"] = op._b64(op.scalar_to_bytes(c))
    elif tamper == "evaluated":
        responses[0]["evaluated"] = responses[1]["evaluated"]
    elif tamper == "server key":
        server = keys["shares"][2]["publicKey"]
    else:
        bad = bytearray(op._unb64(responses[0]["evaluated"]))
        bad[31] = 0x7F
        bad[:31] = b"\xff" * 31               # y >= q
        responses[0]["evaluated"] = op._b64(bytes(bad))
    for mod, o_ in ((op, o), (jop, jop.make_oprf_operator())):
        with pytest.raises(ValueError):
            o_.finalise_oprf(server, request, responses)


def test_oprf_operator_verify_uses_the_toprf_key_on_cpu():
    """The share operator's proof surface goes through the port's
    Groth16Operator on the given device, with the committed chacha20-toprf
    verifying key: a proof of the right form but wrong points is refused,
    and so is a malformed one (both return False, as the reference)."""
    from zksc_tpu_torch import api
    from zksc_tpu_torch.curve import bn254_host as host
    from zksc_tpu_torch.groth16.prove import Proof
    o = op.make_oprf_operator("chacha20", device="cpu")
    assert o.device == "cpu"
    r = oprf.OPRFResponse((1, 2), (3, 4), oprf.DLEQProof(5, 6))
    sig = api.ZKTOPRFPublicSignals(
        locations=[(0, 8)], domain_separator=b"reclaim", output=7,
        responses=[api.TOPRFResponseSignals(1, r.public_key, r.evaluated,
                                            r.dleq.c, r.dleq.r)])
    pub = api.get_public_signals_toprf("chacha20", bytes(128), bytes(12), sig)
    fake = Proof(host.G1_GEN, host.G2_GEN, host.G1_GEN).to_json_dict()
    assert o.verify(pub, fake) is False
    assert o.verify(pub, {}) is False


BITMASK_CASES = [
    ("full blocks", 512, [(3, 5), (40, 2)], [64, 64], 64),
    ("partial blocks", 512, [(3, 5), (60, 10)], [62, 50], 64),
    ("empty block", 1024, [(10, 20)], [16, 0, 16, 16, 16, 16, 16, 16], 16),
    ("location objects", 256, [loc.Location(0, 4)], [16, 16], 16),
    ("overlap", 512, [(3, 5), (6, 2)], [64, 64], 64),
    ("out of bounds", 128, [(10, 10)], [16], 16),
]


@pytest.mark.parametrize("case", BITMASK_CASES, ids=[c[0] for c in BITMASK_CASES])
def test_compute_bitmask_equals_reference(case):
    _, total, locs, bnds, bs = case
    jlocs = [jloc.Location(l.pos, l.length) if isinstance(l, loc.Location)
             else l for l in locs]
    try:
        want = jloc.compute_bitmask(total, jlocs, bnds, bs)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            loc.compute_bitmask(total, locs, bnds, bs)
        return
    got = loc.compute_bitmask(total, locs, bnds, bs)
    assert got == want and len(got) == total and sum(got) > 0

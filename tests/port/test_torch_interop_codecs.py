"""Port vs reference: the gnark and snarkjs codecs (zksc_tpu_torch.interop.
gnark / snarkjs vs zksc_tpu.interop's). Points and scalars are made from a
seed on the host; the keys and the proof are the port's, made by its setup
and prover on the CPU for a toy circuit, and the JAX functions are applied
to the same host values. Every codec is compared byte for byte and every
field value as a Python int.

Tolerance: none (exact).
"""
import json
import random
import struct
from types import SimpleNamespace

import numpy as np
import pytest

from zksc_tpu.groth16.prove import Proof as JProof
from zksc_tpu.interop import gnark as jgk
from zksc_tpu.interop import snarkjs as jsj
from zksc_tpu_torch.curve import bn254_host as host
from zksc_tpu_torch.groth16 import ProverContext, setup, verify
from zksc_tpu_torch.groth16.prove import Proof
from zksc_tpu_torch.interop import gnark as tgk
from zksc_tpu_torch.interop import snarkjs as tsj
from zksc_tpu_torch.r1cs import compile_circuit, generate_witness

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def _define(api, v):
    x = v["x"][0]
    acc = x
    for _ in range(6):
        acc = api.mul(acc, x)
    api.assert_eq(api.add(acc, api.constant(5)), v["out"][0])


@pytest.fixture(scope="module")
def toy():
    """The port's keys and one proof of x^7 + 5 = out, made on the CPU."""
    cs = compile_circuit(_define, [("out", 1)], [("x", 1)])
    rng = random.Random(5)
    pk, vk = setup(cs, rng=lambda: rng.randrange(2, host.R), device="cpu")
    x = 3
    out = (pow(x, 7, host.R) + 5) % host.R
    wit = generate_witness(_define, [("out", 1)], [("x", 1)],
                           {"out": [[out]]}, {"x": [[x]]}, batch=1)[:, 0]
    ctx = ProverContext(cs, pk, device="cpu", force_pippenger=True)
    proof = ctx.prove(wit, rng=lambda: rng.randrange(host.R))
    assert verify(vk, proof, [out])
    return SimpleNamespace(cs=cs, pk=pk, vk=vk, wit=wit, out=out, proof=proof)


def _points(seed: int, n: int, g2: bool) -> list:
    rng = random.Random(seed)
    mul, gen = (host.g2_mul, host.G2_GEN) if g2 else (host.g1_mul, host.G1_GEN)
    return [mul(gen, rng.randrange(1, host.R)) for _ in range(n)] + [None]


def test_g1_codec_equal():
    for pt in _points(3, 16, False):
        enc = tgk.g1_to_bytes(pt)
        assert enc == jgk.g1_to_bytes(pt) and len(enc) == 32
        assert tgk.g1_from_bytes(enc) == jgk.g1_from_bytes(enc) == (pt, 32)
        if pt is not None:                       # the uncompressed form
            raw = pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")
            assert tgk.g1_from_bytes(raw) == jgk.g1_from_bytes(raw) == (pt, 64)


def test_g2_codec_equal():
    for pt in _points(4, 6, True):
        enc = tgk.g2_to_bytes(pt)
        assert enc == jgk.g2_to_bytes(pt) and len(enc) == 64
        assert tgk.g2_from_bytes(enc) == jgk.g2_from_bytes(enc) == (pt, 64)
        if pt is not None:
            (x0, x1), (y0, y1) = pt
            raw = b"".join(v.to_bytes(32, "big") for v in (x1, x0, y1, y0))
            assert tgk.g2_from_bytes(raw) == jgk.g2_from_bytes(raw) == (pt, 128)


def _off_subgroup_point():
    """A point of the twist outside the order-r subgroup."""
    b = tgk._b2()
    for x0 in range(1, 50):
        x = (x0, 0)
        x3 = tgk._fp2_mul(tgk._fp2_mul(x, x), x)
        y = tgk._fp2_sqrt(((x3[0] + b[0]) % tgk.P, (x3[1] + b[1]) % tgk.P))
        if y is not None and not host.g2_in_subgroup((x, y)):
            return (x, y)
    raise AssertionError("no twist point found")


def _off_subgroup_g2():
    return tgk.g2_to_bytes(_off_subgroup_point())


def test_codecs_reject_malformed():
    g1 = bytearray(tgk.g1_to_bytes(host.G1_GEN))
    g1[0] |= 0x3F
    g1[1:] = b"\xff" * 31                        # x >= p
    not_on = bytearray(32)
    not_on[-1] = 4                               # x^3 + 3 is a non-residue
    not_on[0] |= tgk.FLAG_SMALLEST
    bad_inf = bytearray(tgk.g1_to_bytes(None))
    bad_inf[-1] = 1
    cases_g1 = [bytes(g1), bytes(not_on), b"\x01", bytes(bad_inf),
                bytes(64)[:40]]
    cases_g2 = [_off_subgroup_g2(), bytes([tgk.FLAG_SMALLEST]) + b"\xff" * 63,
                b"\x00" * 70]
    for mod in (jgk, tgk):
        for bad in cases_g1:
            with pytest.raises(mod.GnarkFormatError):
                mod.g1_from_bytes(bad)
        for bad in cases_g2:
            with pytest.raises(mod.GnarkFormatError):
                mod.g2_from_bytes(bad)


def test_proof_wire_equal(toy):
    blob = tgk.write_proof(toy.proof)
    jp = JProof(a=toy.proof.a, b=toy.proof.b, c=toy.proof.c)
    assert blob == jgk.write_proof(jp)
    assert len(blob) == 32 + 64 + 32 + 4 + 32
    back = tgk.parse_proof(blob)
    assert isinstance(back, Proof)
    assert (back.a, back.b, back.c) == (toy.proof.a, toy.proof.b, toy.proof.c)
    jb = jgk.parse_proof(blob)
    assert (jb.a, jb.b, jb.c) == (back.a, back.b, back.c)
    bad = bytearray(blob)
    bad[32:96] = _off_subgroup_g2()
    for mod in (jgk, tgk):
        with pytest.raises(mod.GnarkFormatError):
            mod.parse_proof(bytes(bad))
        with pytest.raises(mod.GnarkFormatError):
            mod.parse_proof(blob + b"\x00")


def test_vk_wire_equal_and_verifies(toy):
    gvk = tgk.zksc_to_gnark_vk(toy.vk, toy.pk)
    blob = tgk.write_vk(gvk)
    assert blob == jgk.write_vk(jgk.zksc_to_gnark_vk(toy.vk, toy.pk))
    tv, jv = tgk.parse_vk(blob), jgk.parse_vk(blob)
    assert vars(tv) == vars(jv) == vars(gvk)
    vk2 = tgk.vk_to_zksc(tv)
    assert vk2.ic == toy.vk.ic and vk2.digest == "gnark-import"
    proof = tgk.parse_proof(tgk.write_proof(toy.proof))
    assert verify(vk2, proof, [toy.out])
    assert not verify(vk2, proof, [(toy.out + 1) % host.R])
    gvk.public_and_commitment_committed = [[1]]
    for mod in (jgk, tgk):
        with pytest.raises(mod.GnarkFormatError):
            mod.vk_to_zksc(gvk)
        with pytest.raises(mod.GnarkFormatError):
            mod.parse_vk(blob + b"\x00")
    # a blob cut inside a count: the port raises its format error, the JAX
    # package lets struct.error escape (both reject it)
    with pytest.raises(tgk.GnarkFormatError, match="truncated"):
        tgk.parse_vk(blob[:-1])
    with pytest.raises(struct.error):
        jgk.parse_vk(blob[:-1])


def test_wtns_equal(toy):
    blob = tsj.write_wtns(toy.wit)
    assert blob == jsj.write_wtns(toy.wit)
    back = tsj.read_wtns(blob)
    assert back == jsj.read_wtns(blob) == [int(v) % host.R for v in toy.wit]
    assert back[0] == 1
    big = bytearray(blob)
    big[-32:] = (host.R).to_bytes(32, "little")          # a value >= r
    for mod in (jsj, tsj):
        with pytest.raises(mod.SnarkjsFormatError):
            mod.read_wtns(bytes(big))
        with pytest.raises(mod.SnarkjsFormatError):
            mod.read_wtns(b"zkey" + blob[4:])


def test_vkey_json_equal_and_verifies(toy):
    d = tsj.vkey_to_json(toy.vk)
    text = json.dumps(d, sort_keys=True)
    assert text == json.dumps(jsj.vkey_to_json(toy.vk), sort_keys=True)
    assert d["nPublic"] == toy.cs.n_public
    vk2 = tsj.vkey_from_json(json.loads(text))
    jv = jsj.vkey_from_json(json.loads(text))
    assert (vk2.alpha_g1, vk2.beta_g2, vk2.gamma_g2, vk2.delta_g2, vk2.ic) == \
        (jv.alpha_g1, jv.beta_g2, jv.gamma_g2, jv.delta_g2, jv.ic)
    assert verify(vk2, toy.proof, [toy.out])
    assert not verify(vk2, toy.proof, [(toy.out + 1) % host.R])
    for mod in (jsj, tsj):
        with pytest.raises(mod.SnarkjsFormatError):
            mod.vkey_from_json({**d, "protocol": "plonk"})


def _np_jac(pt):
    return SimpleNamespace(x=pt.x.numpy(), y=pt.y.numpy(), z=pt.z.numpy())


def test_zkey_written_by_port_read_by_reference(toy):
    from zksc_tpu_torch.fields.limb import Fp
    from zksc_tpu_torch.ops import ec
    from zksc_tpu_torch.ops.ntt import bit_reverse_perm
    cs, pk, vk = toy.cs, toy.pk, toy.vk
    blob = tsj.write_zkey(cs, pk, vk)
    # the JAX writer over the same key, its tables as numpy limbs
    jpk = SimpleNamespace(**{**vars(pk), **{
        k: _np_jac(getattr(pk, k)) for k in (
            "a_query", "b_g1_query", "b_g2_query", "c_query", "h_query")}})
    assert blob == jsj.write_zkey(cs, jpk, vk)
    z = jsj.read_zkey(blob)
    assert z == tsj.read_zkey(blob, device="cpu")
    n = cs.n_wires
    g1 = lambda q: ec.g1_jac_to_host_affine(Fp, q, host.P)
    assert (z["n_vars"], z["n_public"], z["domain_size"]) == (
        n, cs.n_public, pk.domain_n)
    assert (z["alpha_g1"], z["beta_g1"], z["delta_g1"]) == (
        pk.alpha_g1, pk.beta_g1, pk.delta_g1)
    assert (z["beta_g2"], z["gamma_g2"], z["delta_g2"]) == (
        pk.beta_g2, vk.gamma_g2, pk.delta_g2)
    assert z["ic"] == vk.ic
    assert z["a_query"] == g1(pk.a_query)[:n]
    assert z["b_g1_query"] == g1(pk.b_g1_query)[:n]
    assert z["b_g2_query"] == ec.g2_jac_to_host_affine(
        Fp, pk.b_g2_query, host.P)[:n]
    assert z["c_query"] == g1(pk.c_query)[:n - cs.n_public - 1]
    h_br = g1(pk.h_query)
    br = bit_reverse_perm(pk.domain_n)
    assert z["h_query"] == [h_br[int(np.nonzero(br == i)[0][0])]
                            for i in range(pk.domain_n)]
    want = [(m, k, w, c % host.R) for k, (la, lb, _) in enumerate(cs.constraints)
            for m, lc in ((0, la), (1, lb)) for w, c in lc.items()]
    assert z["coeffs"] == want


def _section_offset(blob: bytes, want: int) -> int:
    """Payload offset of section `want` in an iden3 binfile."""
    off = 12
    while True:
        stype, size = struct.unpack_from("<IQ", blob, off)
        if stype == want:
            return off + 12
        off += 12 + size


def test_zkey_rejects_garbage(toy):
    good = tsj.write_zkey(toy.cs, toy.pk, toy.vk)
    blob = bytearray(good)
    blob[200] ^= 0xFF          # inside the groth16 header points
    # a B2 query point on the twist but outside the r-torsion: the port's
    # batched order check (the plain ladder here) rejects it
    bad_b2 = bytearray(good)
    off = _section_offset(good, 7) + 128
    bad_b2[off:off + 128] = tsj._g2_bytes(_off_subgroup_point())
    for mod in (jsj, tsj):
        kw = {"device": "cpu"} if mod is tsj else {}
        with pytest.raises(mod.SnarkjsFormatError):
            mod.read_zkey(b"nope" + bytes(32), **kw)
        with pytest.raises(mod.SnarkjsFormatError):
            mod.read_zkey(bytes(blob), **kw)
        with pytest.raises(mod.SnarkjsFormatError, match="r-torsion"):
            mod.read_zkey(bytes(bad_b2), **kw)

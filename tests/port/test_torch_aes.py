"""Port vs reference: the AES-128/256-CTR statements (host side).

The numpy AES of ops/ciphers.py against the JAX package's (tables, key
schedule, CTR) and the FIPS 197 / SP 800-38A vectors; the AES circuits
(r1cs/circuits/aes.py): one-block circuits with the JAX package's digest and
a witness that satisfies them and equals the JAX witness, the full 5-block
circuits with the digests of the committed manifests; the API's witness
input and public signals equal the JAX package's. Nothing here touches a
device: the AES proof itself runs on the card (chip_smoke.py phase 6)."""
import json
import os

import numpy as np
import pytest

from zksc_tpu import api as japi
from zksc_tpu import operators as jops
from zksc_tpu.ops import ciphers as jc
from zksc_tpu.r1cs import compile_circuit as j_compile
from zksc_tpu.r1cs import generate_witness as j_witness
from zksc_tpu.r1cs.circuits import aes as jaes
from zksc_tpu_torch import api as tapi
from zksc_tpu_torch import operators as tops
from zksc_tpu_torch.ops import ciphers as tc
from zksc_tpu_torch.r1cs import check_witness, compile_circuit, generate_witness
from zksc_tpu_torch.r1cs.circuits import aes as taes

ART = os.path.join(os.path.dirname(__file__), "..", "..", "artifacts")
ALGS = ("aes-128-ctr", "aes-256-ctr")


def _block(key: bytes, pt: bytes) -> bytes:
    rks = tc.aes_expand_key(np.frombuffer(key, np.uint8))
    return tc._aes_encrypt_blocks_np(np.frombuffer(pt, np.uint8)[None], rks
                                     ).tobytes()


def test_aes_tables_and_vectors():
    for name in ("AES_SBOX", "AES_INV_SBOX", "AES_RCON", "AES_GF_INV"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name))
    # FIPS 197 Appendix B (AES-128) and C.3 (AES-256)
    assert _block(bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"),
                  bytes.fromhex("3243f6a8885a308d313198a2e0370734")) == \
        bytes.fromhex("3925841d02dc09fbdc118597196a0b32")
    assert _block(bytes(range(32)),
                  bytes.fromhex("00112233445566778899aabbccddeeff")) == \
        bytes.fromhex("8ea2b7ca516745bfeafc49904b496089")
    # SP 800-38A F.5.1 CTR-AES128 (nonce || BE32 counter)
    init = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    pt = bytes.fromhex("6bc1bee22e409f96e93d7e117393172a"
                       "ae2d8a571e03ac9c9eb76fac45af8e51")
    assert tc.aes_ctr_encrypt(key, init[:12], int.from_bytes(init[12:], "big"),
                              pt) == bytes.fromhex(
        "874d6191b620e3261bef6864990db6ce9806f66b7970fdff8617187bb9fffdff")


@pytest.mark.parametrize("key_len", [16, 32])
def test_aes_ctr_matches_jax(key_len):
    rs = np.random.RandomState(key_len)
    for n in (1, 16, 80, 95):
        key = rs.bytes(key_len)
        nonce = rs.bytes(12)
        data = rs.bytes(n)
        ctr = int(rs.randint(0, 2**31))
        np.testing.assert_array_equal(
            tc.aes_expand_key(np.frombuffer(key, np.uint8)),
            jc.aes_expand_key(np.frombuffer(key, np.uint8)))
        assert tc.aes_ctr_encrypt(key, nonce, ctr, data) == \
            jc.aes_ctr_encrypt(key, nonce, ctr, data)


@pytest.mark.parametrize("key_bits", [128, 256])
def test_one_block_circuit_digest_and_witness(key_bits):
    pub, priv = taes.public_layout(1), taes.private_layout(1, key_bits)
    tcs = compile_circuit(taes.make_define(1, key_bits), pub, priv)
    jcs = j_compile(jaes.make_define(1, key_bits), jaes.public_layout(1),
                    jaes.private_layout(1, key_bits))
    assert tcs.digest() == jcs.digest()
    rs = np.random.RandomState(key_bits)
    key, nonce, ct = rs.bytes(key_bits // 8), rs.bytes(12), rs.bytes(16)
    ctr = 7
    out = tc.aes_ctr_encrypt(key, nonce, ctr, ct)
    args = ([key], [[(nonce, ctr)]], [[ct]], [[out]], 1)
    tp, tv = taes.witness_inputs(*args)
    assert (tp, tv) == jaes.witness_inputs(*args)
    w = generate_witness(taes.make_define(1, key_bits), pub, priv, tp, tv,
                         batch=1)
    assert check_witness(tcs, w)
    jw = j_witness(jaes.make_define(1, key_bits), pub, priv, tp, tv, batch=1)
    np.testing.assert_array_equal(np.asarray(w), np.asarray(jw))
    # a wrong plaintext bit breaks the witness
    tp["out0"][0][0] ^= 1
    bad = generate_witness(taes.make_define(1, key_bits), pub, priv, tp, tv,
                           batch=1)
    assert not check_witness(tcs, bad)


@pytest.mark.parametrize("alg", ALGS)
def test_full_circuit_matches_manifest(alg):
    with open(os.path.join(ART, alg, "manifest.json")) as f:
        man = json.load(f)
    cs = tops.CircuitSpec(alg).cs
    assert (cs.digest(), cs.n_constraints, cs.n_wires, cs.n_public) == \
        (man["digest"], man["n_constraints"], man["n_wires"], man["n_public"])


@pytest.mark.parametrize("alg", ALGS)
def test_witness_input_and_public_signals_match_jax(alg):
    rs = np.random.RandomState(len(alg))
    key = rs.bytes(16 if alg == "aes-128-ctr" else 32)
    iv, ct = rs.bytes(12), rs.bytes(61)
    for off in (0, 160):
        wi = tapi.generate_zk_witness(alg, key, ct, iv, offset_bytes=off)
        jwi = japi.generate_zk_witness(alg, key, ct, iv, offset_bytes=off)
        assert (wi.plaintext, wi.ciphertext, wi.data_len) == \
            (jwi.plaintext, jwi.ciphertext, jwi.data_len)
        assert [(b.nonce, b.counter, b.boundary) for b in wi.blocks] == \
            [(b.nonce, b.counter, b.boundary) for b in jwi.blocks]
        assert tapi.get_public_signals(alg, ct, iv, wi.plaintext, off) == \
            japi.get_public_signals(alg, ct, iv, jwi.plaintext, off)
    wi = tapi.generate_zk_witness(alg, key, ct, iv)
    jwi = japi.generate_zk_witness(alg, key, ct, iv)
    np.testing.assert_array_equal(
        np.asarray(tops.CircuitSpec(alg).build_witness(wi)),
        np.asarray(jops.CircuitSpec(alg).build_witness(jwi)))

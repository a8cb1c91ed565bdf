"""Port vs reference: the "stark-stwo" engine (byte-identical stwo proofs of
chacha20).

The port's prover on the CPU (plain versions of K7a, K7b and K7c) must give
the committed upstream stwo proofs byte for byte (tests/fixtures, made by
the stwo prover for key range(32), nonce range(12), counter 1), and the JAX
package's bytes on a random chunk; each package's verifier accepts the
other's proof, and the port's verifier accepts both fixtures with the AIR
check on. The API round trip with engine="stark-stwo" rejects a flipped
ciphertext byte and a flipped payload byte. One test for each of the five
checks the port adds to the reference's verifier and prover, on a crafted
input. Each proof is made once, in
a module fixture.
"""
import base64
import gzip
import os

import numpy as np
import pytest

from zksc_tpu.stark.stwo_compat import prover as jp
from zksc_tpu.stark.stwo_compat import verifier as jv
from zksc_tpu_torch import api
from zksc_tpu_torch.operators import StwoCompatOperator, make_operator
from zksc_tpu_torch.ops.ciphers import chacha20_encrypt
from zksc_tpu_torch.stark.stwo_compat import codec
from zksc_tpu_torch.stark.stwo_compat import prover as tp
from zksc_tpu_torch.stark.stwo_compat import verifier as tv

FIX = os.path.join(os.path.dirname(__file__), os.pardir, "fixtures")
KEY, NONCE = bytes(range(32)), bytes(range(12))
PT = {"ls4": bytes((i * 7 + 3) & 0xFF for i in range(64)),
      "ls5": bytes((i * 11 + 5) & 0xFF for i in range(64 * 17))}
CT = {tag: chacha20_encrypt(KEY, NONCE, 1, pt) for tag, pt in PT.items()}

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def fixture_bytes(tag):
    with gzip.open(os.path.join(FIX, f"stwo_ref_proof_chacha_{tag}.bin.gz"),
                   "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def port_fixture_proofs():
    return {tag: tp.prove_stream_bytes(KEY, NONCE, 1, PT[tag], CT[tag],
                                       device="cpu") for tag in PT}


@pytest.fixture(scope="module")
def chunk():
    """A random 128-byte chunk proved by both packages."""
    rng = np.random.default_rng(11)
    key, nonce = rng.bytes(32), rng.bytes(12)
    pt = rng.bytes(128)
    ct = chacha20_encrypt(key, nonce, 7, pt)
    return {"nonce": nonce, "pt": pt, "ct": ct,
            "port": tp.prove_stream_bytes(key, nonce, 7, pt, ct, device="cpu"),
            "ref": jp.prove_stream_bytes(key, nonce, 7, pt, ct)}


@pytest.fixture(scope="module")
def api_proof():
    rng = np.random.default_rng(12)
    key, iv = rng.bytes(32), rng.bytes(12)
    ct = chacha20_encrypt(key, iv, 1, rng.bytes(128))
    env = api.generate_proof("chacha20", key, ct, iv, engine="stark-stwo",
                             device="cpu")
    return env, ct, iv


@pytest.mark.parametrize("tag", ["ls4", "ls5"])
def test_prover_byte_identical_to_upstream(port_fixture_proofs, tag):
    assert port_fixture_proofs[tag] == fixture_bytes(tag)


@pytest.mark.parametrize("tag", ["ls4", "ls5"])
def test_verifier_accepts_upstream_proofs(tag):
    """With the AIR check at the OODS point on (the default)."""
    p = codec.decode_stream_proof(fixture_bytes(tag))
    assert tv.verify_stream_proof(p, NONCE, 1, PT[tag], CT[tag],
                                  air_eval=tv.default_air_eval)


def test_verifier_rejects_changed_sample():
    p = codec.decode_stream_proof(fixture_bytes("ls4"))
    v = p.sampled_values[1][100][0]
    p.sampled_values[1][100][0] = ((v[0] + 1) % tv.F.P,) + tuple(v[1:])
    assert not tv.verify_stream_proof(p, NONCE, 1, PT["ls4"], CT["ls4"])


def test_chunk_bytes_equal_and_cross_verified(chunk):
    """The port's bytes equal the JAX package's; each package's verifier
    accepts the other package's proof."""
    assert chunk["port"] == chunk["ref"]
    args = (chunk["nonce"], 7, chunk["pt"], chunk["ct"])
    assert jv.verify_stream_proof_bytes(chunk["port"], *args)
    assert tv.verify_stream_proof_bytes(chunk["ref"], *args)


def test_api_round_trip(api_proof):
    env, ct, iv = api_proof
    d = env.proof_data
    assert d["success"] is True and d["protocol"] == "stwo"
    assert d["algorithm"] == "chacha20" and d["blocks"] == 2
    assert d["proof_size_bytes"] == len(base64.b64decode(d["proof"]))
    assert api.verify_proof(env, ct, iv, engine="stark-stwo", device="cpu")
    # under the default engine the envelope does not verify, as in the
    # reference
    assert not api.verify_proof(env, ct, iv, device="cpu")


def test_api_rejects_tampering(api_proof):
    env, ct, iv = api_proof
    bad = bytearray(ct)
    bad[9] ^= 2
    assert not api.verify_proof(env, bytes(bad), iv, engine="stark-stwo",
                                device="cpu")
    raw = bytearray(base64.b64decode(env.proof_data["proof"]))
    raw[len(raw) // 2] ^= 1
    flipped = api.ProofEnvelope(env.algorithm, dict(
        env.proof_data, proof=base64.b64encode(bytes(raw)).decode()),
        env.plaintext, env.data_len)
    assert not api.verify_proof(flipped, ct, iv, engine="stark-stwo",
                                device="cpu")


def test_operator_takes_no_rng():
    op = make_operator("chacha20", "stark-stwo", device="cpu")
    assert isinstance(op, StwoCompatOperator)
    wi = api.generate_zk_witness("chacha20", KEY, CT["ls4"] * 2, NONCE)
    with pytest.raises(ValueError, match="no rng"):
        op.prove(wi, rng=lambda: 1)
    assert op.verify([0] * 10, {"proof": ""}) is False   # wrong signal count


# ---- the five checks the port adds, each on a crafted input

def _reencoded(tag, **changes):
    p = codec.decode_stream_proof(fixture_bytes(tag))
    for k, v in changes.items():
        setattr(p, k, v)
    return codec.encode_stream_proof(p)


@pytest.mark.parametrize("field,value", [("log_size", 0xFFFFFFFF),
                                         ("log_size", 25),
                                         ("n_queries", 1 << 60)])
def test_check1_oversized_log_size_or_queries_rejected(field, value):
    """Rejected before the channel replay (the JAX package replays and then
    loops over them)."""
    raw = _reencoded("ls4", **{field: value})
    assert tv.verify_stream_proof_bytes(raw, NONCE, 1, PT["ls4"], CT["ls4"]) is False


def test_check2_payload_cap_before_decoding(monkeypatch):
    """The operator refuses a base64 text over 8 MB before decoding it."""
    text = "A" * (8 * 1024 * 1024 + 4)
    with pytest.raises(ValueError, match="8 MB"):
        StwoCompatOperator.proof_bytes({"proof": text})
    assert StwoCompatOperator.proof_bytes({"proof": "AAEC"}) == b"\x00\x01\x02"
    decoded = []
    monkeypatch.setattr(base64, "b64decode", lambda s: decoded.append(s))
    op = StwoCompatOperator("chacha20", device="cpu")
    pub = api.get_public_signals("chacha20", CT["ls4"] * 2, NONCE,
                                 PT["ls4"] * 2)
    assert op.verify(pub, {"proof": text}) is False
    assert decoded == []


def test_check3_missing_trees_give_false():
    """A decodable proof with two trees of queried values: False in the
    port, an IndexError in the JAX package."""
    p = codec.decode_stream_proof(fixture_bytes("ls4"))
    p.queried_values = p.queried_values[:2]
    raw = codec.encode_stream_proof(p)
    assert tv.verify_stream_proof_bytes(raw, NONCE, 1, PT["ls4"], CT["ls4"],
                                        air_eval=None) is False
    with pytest.raises(IndexError):
        jv.verify_stream_proof_bytes(raw, NONCE, 1, PT["ls4"], CT["ls4"],
                                     air_eval=None)
    p = codec.decode_stream_proof(fixture_bytes("ls4"))
    p.decommitments = p.decommitments[:1]
    raw = codec.encode_stream_proof(p)
    assert tv.verify_stream_proof_bytes(raw, NONCE, 1, PT["ls4"], CT["ls4"],
                                        air_eval=None) is False


def test_check4_counter_overflow_raises():
    """Two blocks from counter 2^32 - 1 raise, as upstream's prover does
    (the JAX package wraps the counter); the check comes first."""
    with pytest.raises(ValueError, match="counter overflow"):
        tp.prove_stream(KEY, NONCE, (1 << 32) - 1, bytes(128), bytes(128),
                        device="cpu")


@pytest.mark.parametrize("change", ["const_u32", "const_u8", "decommitments",
                                    "queried_values"])
def test_check5_one_encoding(change):
    """The constants must be 1 and 0, and tree 0 must stay empty: a fixture
    changed in one of them is rejected (the JAX package's structural checks
    accept it: shown for the first)."""
    p = codec.decode_stream_proof(fixture_bytes("ls4"))
    if change == "const_u32":
        p.const_u32 = 2
    elif change == "const_u8":
        p.const_u8 = 1
    elif change == "decommitments":
        p.decommitments[0] = [bytes(32)]
    else:
        p.queried_values[0] = [[0, 0, 0]]
    raw = codec.encode_stream_proof(p)
    assert tv.verify_stream_proof_bytes(raw, NONCE, 1, PT["ls4"], CT["ls4"],
                                        air_eval=None) is False
    if change == "const_u32":
        assert jv.verify_stream_proof(p, NONCE, 1, PT["ls4"], CT["ls4"],
                                      air_eval=None)

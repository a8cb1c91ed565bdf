"""Port vs reference: the "stark" engine for aes-128-ctr and aes-256-ctr
(the LogUp S-box AIR, Circle STARK over M31).

One proof of an 80-byte chunk (5 blocks, log_rows floored at 8) per key
size by each package under the same blinding bytes: the port's bincode
envelope must equal the JAX package's byte for byte, and each package's
verifier must accept the other's proof. The port's aes-128-ctr proof goes
through api.generate_proof (its secrets module replaced by the seeded
stub), the aes-256-ctr one through prove_aes_ctr(rand_bytes=), which must
draw the blinding bytes in the reference's order (phase 1, then phase 2,
none for the public columns). The API round trip on the CPU rejects a
tampered ciphertext byte, openings, roots, a payload byte and a wrong nonce,
for both key sizes; prove_aes_ctr refuses a bad witness."""
import base64
import copy
import types

import numpy as np
import pytest

from zksc_tpu.interop import bincode as jbincode
from zksc_tpu.stark import aes_prover as jp
from zksc_tpu_torch import api
from zksc_tpu_torch.config import get_counter_for_byte_offset
from zksc_tpu_torch.interop import bincode
from zksc_tpu_torch.operators import StarkOperator, make_operator
from zksc_tpu_torch.ops.ciphers import aes_ctr_encrypt
from zksc_tpu_torch.stark import aes_air
from zksc_tpu_torch.stark import aes_prover as tp

NONCE = bytes(range(12))
COUNTER0 = get_counter_for_byte_offset("aes-128-ctr", 0)    # 2, as the API's
BLIND_SEED = 20243


pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def seeded(seed, calls=None):
    rng = np.random.default_rng(seed)

    def draw(n):
        if calls is not None:
            calls.append(n)
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return draw


def _inputs(key_size):
    key = bytes(range(3, 3 + key_size))
    pt = bytes((i * 5 + key_size) & 0xFF for i in range(80))
    return key, pt, aes_ctr_encrypt(key, NONCE, COUNTER0, pt)


@pytest.fixture(scope="module", params=[16, 32], ids=["aes128", "aes256"])
def pair(request):
    """(inputs, the JAX package's proof, the port's envelope, the blinding
    draws and stage timings of the port's proof) of one 80-byte chunk under
    one seeded source of blinding bytes; each package's secrets module is
    replaced by a seeded stub for its one call (the port's aes-256-ctr proof
    takes the source as rand_bytes instead)."""
    key, pt, ct = _inputs(request.param)
    calls, timings = [], {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp, "secrets", types.SimpleNamespace(token_bytes=seeded(BLIND_SEED)))
        ref = jp.prove_aes_ctr(key, NONCE, COUNTER0, pt, ct)
    if request.param == 16:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tp, "secrets", types.SimpleNamespace(
                token_bytes=seeded(BLIND_SEED, calls)))
            env = api.generate_proof("aes-128-ctr", key, ct, NONCE,
                                     engine="stark", device="cpu")
        assert env.plaintext == pt
        port = env.proof_data
        timings = api.get_operator("aes-128-ctr", "stark", "cpu").timings
    else:
        port = tp.prove_aes_ctr(key, NONCE, COUNTER0, pt, ct, device="cpu",
                                rand_bytes=seeded(BLIND_SEED, calls),
                                timings=timings).to_envelope()
    return (key, pt, ct), ref, port, calls, timings


def test_envelope_byte_identical(pair):
    (key, _, _), ref, port, _, _ = pair
    assert port == ref.to_envelope()
    assert port["algorithm"] == ("aes-128-ctr" if len(key) == 16 else "aes-256-ctr")
    assert base64.b64decode(port["proof"]) == jbincode.encode_aes_proof(ref)
    assert tp.AesProof.from_json_dict(port).to_json_dict() == ref.to_json_dict()


def test_cross_verification(pair):
    """The port's proof under the JAX verifier, the JAX proof under the
    port's, both through the wire envelope."""
    (key, pt, ct), ref, port, _, _ = pair
    theirs = jp.AesProof.from_json_dict(port)
    assert jp.verify_aes_ctr(theirs, NONCE, COUNTER0, pt, ct, len(key))
    ours = tp.AesProof.from_json_dict(ref.to_envelope())
    assert tp.verify_aes_ctr(ours, NONCE, COUNTER0, pt, ct, len(key), device="cpu")


def test_bincode_round_trip(pair):
    _, _, port, _, _ = pair
    raw = base64.b64decode(port["proof"])
    proof = bincode.decode_aes_proof(raw)
    assert bincode.encode_aes_proof(proof) == raw
    assert bincode.encode_aes_proof(bincode.proof_from_envelope(port)) == raw
    with pytest.raises(ValueError, match="trailing"):
        bincode.decode_aes_proof(raw + b"\0")
    back = tp.AesProof.from_json_dict(proof.to_json_dict())
    assert bincode.encode_aes_proof(back) == raw


def test_blinding_drawn_in_reference_order(pair):
    """The prover asks for 4 x n1 x 50 bytes (phase 1), then 4 x n2 x 50
    (phase 2), and nothing for the public columns, as the reference's two
    secrets.token_bytes calls; the stage timings come back, lde and merkle
    summed over both phases."""
    (key, _, _), _, _, calls, timings = pair
    n1, n2, _ = aes_air.layout(len(key))
    assert calls == [4 * n1 * tp.ZK_COEFFS, 4 * n2 * tp.ZK_COEFFS]
    assert list(timings) == ["trace", "lde", "merkle", "interaction",
                             "composition", "fri", "openings"]


def test_api_witness_and_operator():
    """A short chunk is zero-padded to 80 bytes with counters from 2."""
    key, pt, ct = _inputs(16)
    assert isinstance(make_operator("aes-256-ctr", "stark", device="cpu"),
                      StarkOperator)
    wi = api.generate_zk_witness("aes-128-ctr", key, ct[:70], NONCE)
    assert wi.plaintext[:70] == pt[:70] and len(wi.plaintext) == 80
    assert [b.counter for b in wi.blocks] == list(range(COUNTER0, COUNTER0 + 5))


def _with_proof(env, proof):
    return api.ProofEnvelope(env.algorithm, proof.to_envelope(), env.plaintext,
                             env.data_len)


def _rejected(env, ct, nonce=NONCE):
    return not api.verify_proof(env, ct, nonce, engine="stark", device="cpu")


def test_api_verifies_and_rejects_tampering(pair):
    (key, pt, ct), _, port, _, _ = pair
    env = api.ProofEnvelope(port["algorithm"], port, pt, len(ct))
    assert env.proof_data["protocol"] == "circle-stark-aes"
    assert api.verify_proof(env, ct, NONCE, engine="stark", device="cpu")
    assert not api.verify_proof(env, ct, NONCE, device="cpu")  # groth16 default
    proof = tp.AesProof.from_json_dict(env.proof_data)
    assert _rejected(env, bytes([ct[0] ^ 1]) + ct[1:])          # a ciphertext byte
    assert _rejected(env, ct, nonce=bytes(12))                   # the nonce
    for part in ("openings1", "openings1s", "openings2", "openings2s"):
        bad = copy.deepcopy(proof)                               # an opening
        ops = getattr(bad, part)
        ops[1].values = ops[1].values.copy()
        ops[1].values[3] ^= 1
        assert _rejected(_with_proof(env, bad), ct), part
    for root in ("root1", "root2"):
        bad = copy.deepcopy(proof)                               # a root
        setattr(bad, root, bytes(32))
        assert _rejected(_with_proof(env, bad), ct), root
    raw = bytearray(base64.b64decode(env.proof_data["proof"]))
    raw[len(raw) // 2] ^= 1                                      # the payload
    flipped = api.ProofEnvelope(env.algorithm, dict(
        env.proof_data, proof=base64.b64encode(bytes(raw)).decode()),
        env.plaintext, env.data_len)
    assert _rejected(flipped, ct)


def test_prove_rejects_bad_witness():
    """As the reference's test_stark_aes.py:136-150."""
    key = bytes(range(16))
    pt = bytes(32)
    ct = aes_ctr_encrypt(key, NONCE, 2, pt)
    bad_ct = bytes([ct[0] ^ 1]) + ct[1:]
    with pytest.raises(AssertionError):
        tp.prove_aes_ctr(key, NONCE, 2, pt, bad_ct, device="cpu")
    with pytest.raises(ValueError):
        tp.prove_aes_ctr(key, NONCE, 2, pt, ct[:-1], device="cpu")
    with pytest.raises(ValueError):
        tp.prove_aes_ctr(key[:-1], NONCE, 2, pt, ct, device="cpu")
    with pytest.raises(ValueError):
        tp.prove_aes_ctr(key, NONCE, (1 << 32) - 4, pt, ct, device="cpu")

"""Port vs reference: the "stark" engine for chacha20 (Circle STARK over M31).

One proof of a 128-byte chunk (2 blocks, log_rows 6) by each package under
the same blinding bytes: the port's bincode envelope must equal the JAX
package's byte for byte, and each package's verifier must accept the other's
proof. The composition's plain version (what K7c is held to on the card)
equals the reference's jitted _composition. The API round trip on the CPU
rejects a tampered statement, tampered openings and a flipped ciphertext
byte; the statements not ported yet still raise, "stark-stwo" gives its
operator for chacha20 and raises for AES as the reference does (the AES
statements under "stark": tests/port/test_torch_stark_aes.py; stark-stwo:
tests/port/test_torch_stwo.py)."""
import base64
import copy
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksc_tpu import operators as joperators
from zksc_tpu.interop import bincode as jbincode
from zksc_tpu.stark import prover as jp
from zksc_tpu_torch import api
from zksc_tpu_torch.interop import bincode
from zksc_tpu_torch.operators import (StarkOperator, StwoCompatOperator,
                                      make_operator)
from zksc_tpu_torch.ops.ciphers import chacha20_encrypt
from zksc_tpu_torch.stark import chacha_air
from zksc_tpu_torch.stark import prover as tp

KEY = bytes(range(32))
NONCE = bytes(range(12))
PT = bytes((i * 7 + 3) & 0xFF for i in range(128))
CT = chacha20_encrypt(KEY, NONCE, 1, PT)
BLIND_SEED = 20242


pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def seeded(seed):
    rng = np.random.default_rng(seed)
    return lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def ref():
    """The JAX package's proof, its secrets module replaced by a seeded
    stub for this one call."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp, "secrets", types.SimpleNamespace(token_bytes=seeded(BLIND_SEED)))
        return jp.prove_stream(KEY, NONCE, 1, PT, CT)


@pytest.fixture(scope="module")
def port():
    return tp.prove_stream(KEY, NONCE, 1, PT, CT, device="cpu",
                           rand_bytes=seeded(BLIND_SEED))


def test_envelope_byte_identical(ref, port):
    want, got = ref.to_envelope(), port.to_envelope()
    assert got == want
    assert base64.b64decode(got["proof"]) == jbincode.encode_stream_proof(ref)
    assert port.to_json_dict() == ref.to_json_dict()


def test_cross_verification(ref, port):
    """The port's proof under the JAX verifier, the JAX proof under the
    port's, both through the wire envelope."""
    theirs = jp.StreamProof.from_json_dict(port.to_envelope())
    assert jp.verify_stream(theirs, NONCE, 1, PT, CT)
    ours = tp.StreamProof.from_json_dict(ref.to_envelope())
    assert tp.verify_stream(ours, NONCE, 1, PT, CT, device="cpu")


def test_composition_plain_matches_reference(ref):
    """_composition_plain == the reference's _composition at log_rows 6 on
    random values of the prover's shapes (R x M = 33,025 x 1,024)."""
    n_comm, groups = chacha_air.layout()
    _, m, _ = tp._domain_params(6)
    rng = np.random.default_rng(6)
    R = n_comm + chacha_air.N_PUBLIC + 1
    vals = rng.integers(0, tp.P31, (R, m)).astype(np.uint32)
    weights = rng.integers(0, tp.P31, (tp._n_constraints(groups), 4)).astype(np.uint32)
    vn_inv = tp._vn_evals(6)[1]
    np.testing.assert_array_equal(vn_inv, jp._vn_evals(6)[1])
    want = np.asarray(jp._composition(
        jnp.asarray(vals), {k: (jnp.asarray(v) if not isinstance(v, dict) else
                                {f: jnp.asarray(a) for f, a in v.items()})
                            for k, v in groups.items()},
        jnp.asarray(weights), jnp.asarray(vn_inv), 0, ()))
    got = tp._composition_plain(torch.from_numpy(vals.astype(np.int32)), groups,
                                torch.from_numpy(weights.astype(np.int32)),
                                torch.from_numpy(vn_inv.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_blinding_bytes_drawn_once():
    """prove_stream asks rand_bytes for 4 x 32,256 x 50 bytes, once, as the
    reference's secrets.token_bytes call (prover.py:342); the stage
    timings come back."""
    calls, timings = [], {}
    src = seeded(1)

    def rand(n):
        calls.append(n)
        return src(n)
    tp.prove_stream(KEY, NONCE, 1, PT, CT, device="cpu", rand_bytes=rand,
                    timings=timings)
    n_comm, _ = chacha_air.layout()
    assert calls == [4 * n_comm * tp.ZK_COEFFS]
    assert list(timings) == ["trace", "lde", "merkle", "composition", "fri",
                             "openings"]


def test_bincode_round_trip_and_cap(port):
    raw = bincode.encode_stream_proof(port)
    back = bincode.decode_stream_proof(raw)
    assert bincode.encode_stream_proof(back) == raw
    env = port.to_envelope()
    assert bincode.encode_stream_proof(bincode.proof_from_envelope(env)) == raw
    with pytest.raises(ValueError, match="8 MB"):
        bincode.proof_from_envelope(dict(env, proof="A" * (8 * 1024 * 1024 + 4)))
    with pytest.raises(ValueError, match="trailing"):
        bincode.decode_stream_proof(raw + b"\0")
    # an envelope named aes goes to the AES codec, which refuses this payload
    with pytest.raises(ValueError, match="length prefix"):
        bincode.proof_from_envelope(dict(env, algorithm="aes-128-ctr"))


@pytest.fixture(scope="module")
def api_proof():
    ct = CT[:100]                      # a short chunk, zero-padded to 128 B
    return ct, api.generate_proof("chacha20", KEY, ct, NONCE, engine="stark",
                                  device="cpu")


def test_api_round_trip(api_proof):
    ct, env = api_proof
    assert env.proof_data["protocol"] == "circle-stark"
    assert env.plaintext[:100] == PT[:100]
    assert api.verify_proof(env, ct, NONCE, engine="stark", device="cpu")


def _with_proof(env, proof):
    return api.ProofEnvelope(env.algorithm, proof.to_envelope(), env.plaintext,
                             env.data_len)


def test_api_rejects_tampering(api_proof):
    ct, env = api_proof
    proof = tp.StreamProof.from_json_dict(env.proof_data)
    bad = copy.deepcopy(proof)
    bad.stmt.ct_hash = bytes(32)                      # the statement
    assert not api.verify_proof(_with_proof(env, bad), ct, NONCE,
                                engine="stark", device="cpu")
    bad = copy.deepcopy(proof)
    bad.openings[0].values = bad.openings[0].values.copy()
    bad.openings[0].values[5] ^= 1                    # a trace opening
    assert not api.verify_proof(_with_proof(env, bad), ct, NONCE,
                                engine="stark", device="cpu")
    bad = copy.deepcopy(proof)
    v = list(bad.fri.openings[3][1].value)            # a FRI opening
    v[0] = (v[0] + 1) % tp.P31
    bad.fri.openings[3][1].value = tuple(v)
    assert not api.verify_proof(_with_proof(env, bad), ct, NONCE,
                                engine="stark", device="cpu")
    flipped = bytes([ct[0] ^ 1]) + ct[1:]             # the ciphertext
    assert not api.verify_proof(env, flipped, NONCE, engine="stark",
                                device="cpu")
    raw = bytearray(base64.b64decode(env.proof_data["proof"]))
    raw[len(raw) // 2] ^= 1                           # the bincode payload
    flipped_env = api.ProofEnvelope(env.algorithm, dict(
        env.proof_data, proof=base64.b64encode(bytes(raw)).decode()),
        env.plaintext, env.data_len)
    assert not api.verify_proof(flipped_env, ct, NONCE, engine="stark",
                                device="cpu")


def test_operator_and_engines_not_ported():
    for alg in ("chacha20", "aes-128-ctr", "aes-256-ctr"):
        assert isinstance(make_operator(alg, "stark", device="cpu"),
                          StarkOperator)
    for alg in ("chacha20-toprf", "aes-128-ctr-toprf"):
        with pytest.raises(ValueError, match="not ported yet"):
            make_operator(alg, "stark", device="cpu")
    # stark-stwo: chacha20 only, as in the reference (whose operator raises
    # ValueError for AES too)
    assert isinstance(make_operator("chacha20", "stark-stwo", device="cpu"),
                      StwoCompatOperator)
    with pytest.raises(ValueError, match="chacha20 only"):
        make_operator("aes-128-ctr", "stark-stwo", device="cpu")
    with pytest.raises(ValueError):
        joperators.make_operator("aes-128-ctr", "stark-stwo")
    with pytest.raises(ValueError, match="chacha20 only"):
        api.generate_proof("aes-128-ctr", bytes(16), CT[:80], NONCE,
                           engine="stark-stwo", device="cpu")
    op = StarkOperator("chacha20", device="cpu")
    wi = api.generate_zk_witness("chacha20", KEY, CT, NONCE)
    with pytest.raises(ValueError, match="no rng"):
        op.prove(wi, rng=lambda: 1)
    assert op.verify([0] * 10, {}) is False          # wrong signal count

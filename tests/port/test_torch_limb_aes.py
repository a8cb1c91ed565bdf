"""Port vs reference: the rest of LimbField (double, mont_sqr, mul_const,
mont_pow, inv, eq, one_limbs) against zksc_tpu.fields.limb and Python ints
at 64 lanes, and the batched AES functions (aes_encrypt_blocks,
aes_ctr_counter_blocks, aes_ctr_keystream) against the JAX functions and the
numpy twin _aes_encrypt_blocks_np for AES-128 and AES-256 at 8 blocks.
Inputs come from seeded random; the port runs its plain path on the CPU.

Tolerance: none (exact).
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksc_tpu.fields import limb as jl
from zksc_tpu.ops import ciphers as jc
from zksc_tpu_torch.fields import limb as tl
from zksc_tpu_torch.ops import ciphers as tc

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


@pytest.fixture(scope="module", params=("Fp", "Fr"))
def field(request):
    JF, TF = getattr(jl, request.param), getattr(tl, request.param)
    rng = random.Random(11)
    vals = [0, 1, 2, JF.p - 1, JF.p - 2, 1 << 253] + [
        rng.randrange(JF.p) for _ in range(58)]
    a = JF.to_device(vals)
    return JF, TF, vals, a, TF.to_device(vals)


def _eq(ref, got: torch.Tensor):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  got.numpy().astype(np.int64))


def test_double_sqr_mul_const(field):
    JF, TF, vals, a, t = field
    p = JF.p
    _eq(JF.double(a), TF.double(t))
    _eq(JF.mont_sqr(a), TF.mont_sqr(t))
    _eq(JF.mul_const(a, 77), TF.mul_const(t, 77))
    assert TF.from_device(TF.double(t)) == [2 * v % p for v in vals]
    assert TF.from_device(TF.mont_sqr(t)) == [v * v % p for v in vals]
    for k in (0, 1, p - 1, 3 << 200):
        assert TF.from_device(TF.mul_const(t, k)) == [v * k % p for v in vals]


def test_mont_pow_and_inv(field):
    JF, TF, vals, a, t = field
    p = JF.p
    _eq(JF.mont_pow(a, 65537), TF.mont_pow(t, 65537))
    inv = TF.inv(t)
    _eq(JF.inv(a), inv)
    # inv(0) = 0, as the reference's a^(p-2)
    assert TF.from_device(inv) == [pow(v, p - 2, p) for v in vals]
    assert TF.from_device(inv)[0] == 0
    for k in (0, 1, 2):
        assert TF.from_device(TF.mont_pow(t, k)) == [pow(v, k, p) for v in vals]


def test_eq_and_one_limbs(field):
    JF, TF, vals, a, t = field
    b_vals = list(vals)
    b_vals[5] = (b_vals[5] + 1) % JF.p
    b_vals[40] = (b_vals[40] + (1 << 200)) % JF.p
    jb, tb = JF.to_device(b_vals), TF.to_device(b_vals)
    got = TF.eq(t, tb)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(JF.eq(a, jb)), got.numpy())
    assert got.tolist() == [x == y for x, y in zip(vals, b_vals)]
    np.testing.assert_array_equal(JF.one_limbs, TF.one_limbs)
    one = torch.from_numpy(TF.one_limbs.astype(np.int32))[:, None]
    assert TF.from_device(one) == [1]


def _aes_inputs(key_size: int, seed: int):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 256, key_size, dtype=np.uint8)
    nonce = rng.integers(0, 256, (8, 12), dtype=np.uint8)
    ctrs = np.array([0, 1, 2, 0xFF, 0x100, 0xFFFFFF, 0xFFFFFFFE,
                     0xFFFFFFFF], dtype=np.uint32)
    return key, nonce, ctrs


@pytest.mark.parametrize("key_size", [16, 32])
def test_aes_blocks_and_keystream(key_size):
    key, nonce, ctrs = _aes_inputs(key_size, key_size)
    rks = tc.aes_expand_key(key)
    np.testing.assert_array_equal(rks, jc.aes_expand_key(key))
    ivs = tc.aes_ctr_counter_blocks(torch.from_numpy(nonce),
                                    torch.from_numpy(ctrs.astype(np.int64)))
    assert ivs.dtype == torch.uint8 and ivs.shape == (8, 16)
    j_ivs = jc.aes_ctr_counter_blocks(jnp.asarray(nonce), jnp.asarray(ctrs))
    np.testing.assert_array_equal(np.asarray(j_ivs), ivs.numpy())
    got = tc.aes_encrypt_blocks(ivs, rks)
    np.testing.assert_array_equal(
        np.asarray(jc.aes_encrypt_blocks(j_ivs, jnp.asarray(rks))), got.numpy())
    np.testing.assert_array_equal(jc._aes_encrypt_blocks_np(ivs.numpy(), rks),
                                  got.numpy())
    ks = tc.aes_ctr_keystream(key.tobytes(), torch.from_numpy(nonce),
                              torch.from_numpy(ctrs.astype(np.int64)))
    np.testing.assert_array_equal(ks.numpy(), got.numpy())
    np.testing.assert_array_equal(
        np.asarray(jc.aes_ctr_keystream(key.tobytes(), jnp.asarray(nonce),
                                        jnp.asarray(ctrs))), ks.numpy())
    # one nonce, sequential counters: the host CTR cipher's keystream
    n0 = torch.from_numpy(np.broadcast_to(nonce[0], (8, 12)).copy())
    ks0 = tc.aes_ctr_keystream(key.tobytes(), n0, torch.arange(5, 13))
    host = tc.aes_ctr_encrypt(key.tobytes(), nonce[0].tobytes(), 5, bytes(128))
    assert ks0.numpy().tobytes() == host


def test_aes_per_lane_round_keys():
    key, nonce, ctrs = _aes_inputs(16, 7)
    keys = np.random.default_rng(8).integers(0, 256, (8, 16), dtype=np.uint8)
    rks = np.stack([tc.aes_expand_key(k) for k in keys])      # [B, 11, 16]
    ivs = np.concatenate([nonce, nonce[:, :4]], axis=1)
    got = tc.aes_encrypt_blocks(torch.from_numpy(ivs), torch.from_numpy(rks))
    np.testing.assert_array_equal(
        np.asarray(jc.aes_encrypt_blocks(jnp.asarray(ivs), jnp.asarray(rks))),
        got.numpy())
    for i in range(8):
        np.testing.assert_array_equal(
            jc._aes_encrypt_blocks_np(ivs[i:i + 1], rks[i]), got[i:i + 1].numpy())

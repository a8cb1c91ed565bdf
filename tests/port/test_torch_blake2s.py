"""Port vs reference: batched Blake2s-256 (zksc_tpu_torch.stark.blake2s, the
plain version K7a is held to on the card) against hashlib, the RFC 7693
"abc" vector and zksc_tpu.stark.blake2s, including the pair hash and the
strided-source addressing the prover uses."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksc_tpu.stark import blake2s as jb
from zksc_tpu_torch.ops import stark_kernels
from zksc_tpu_torch.stark import blake2s as tb

LENGTHS = [0, 1, 63, 64, 65, 200]


def _msgs(seed, n, length):
    return np.random.default_rng(seed).integers(0, 256, (n, length),
                                                dtype=np.uint8)


def test_rfc7693_abc():
    got = tb.blake2s_plain(torch.tensor([list(b"abc")], dtype=torch.uint8), 3)
    assert got.numpy().tobytes().hex() == (
        "508c5e8c327c14e2e1a72ba34eeb452f37458b209ed63a294d999b4c86675982")


@pytest.mark.parametrize("length", LENGTHS)
def test_plain_vs_hashlib_and_jax(length):
    """8 lanes: the plain version, the dispatching blake2s on a CPU tensor,
    the JAX package's blake2s and hashlib agree."""
    d = _msgs(length, 8, length)
    got = tb.blake2s_plain(torch.from_numpy(d), length).numpy()
    np.testing.assert_array_equal(got, tb.blake2s(torch.from_numpy(d), length).numpy())
    np.testing.assert_array_equal(got, np.asarray(jb.blake2s(jnp.asarray(d), length)))
    for i in range(8):
        assert got[i].tobytes() == hashlib.blake2s(d[i].tobytes(),
                                                   digest_size=32).digest()


def test_pair_hash():
    left, right = _msgs(1, 8, 32), _msgs(2, 8, 32)
    got = tb.blake2s_pair(torch.from_numpy(left), torch.from_numpy(right))
    want = jb.blake2s_pair(jnp.asarray(left), jnp.asarray(right))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("length", [5, 64, 130])
def test_strided_sources(length):
    """The addressing K7a shares: messages as the columns of a [words, 8]
    matrix (word stride 8, message stride 1, the trace commitment's read)
    and as pairs of rows of a digest layer (message stride 16)."""
    nw = -(-length // 4)
    words = torch.from_numpy(np.random.default_rng(length).integers(
        -2**31, 2**31, (nw, 8)).astype(np.int32))
    got = tb.hash_strided(words, 8, length, 1, 8)
    msgs = words.T.contiguous().numpy().view(np.uint8)[:, :length]
    for i in range(8):
        assert got[i].numpy().tobytes() == hashlib.blake2s(
            msgs[i].tobytes(), digest_size=32).digest()
    layer = torch.from_numpy(_msgs(9, 16, 32)).view(torch.int32)   # [16, 8]
    pairs = tb.hash_strided(layer, 8, 64, 16, 1)
    flat = layer.numpy().view(np.uint8)
    for i in range(8):
        assert pairs[i].numpy().tobytes() == hashlib.blake2s(
            flat[2 * i].tobytes() + flat[2 * i + 1].tobytes(),
            digest_size=32).digest()
    with pytest.raises(ValueError, match="reaches word"):
        tb.hash_strided(words, 9, length, 1, 8)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        stark_kernels.blake2s(torch.zeros(16, dtype=torch.int32), 1, 64, 16, 1)


@pytest.mark.parametrize("n, words", [(16, 5), (1, 3), (8, 0)])
def test_tree_plain_vs_jax_commit(n, words):
    """The plain version of K7a's tree launch over column leaves (leaf i is
    column i of an int32 [words, n] tensor) gives the JAX package's
    merkle.commit of the transposed rows, every layer, back to back."""
    from zksc_tpu.stark import merkle as jm
    cols = np.random.default_rng(n + words).integers(
        -2**31, 2**31, (max(words, 1), n)).astype(np.int32)
    got = tb.tree_strided(torch.from_numpy(cols), n, 4 * words, 1, n).numpy()
    rows = np.ascontiguousarray(cols.T).view(np.uint8)[:, :4 * words]
    want = np.concatenate(jm.commit(rows).layers).view(np.int32)
    np.testing.assert_array_equal(got, want)


def test_tree_wrapper_refuses_cpu_tensors_and_ragged_trees():
    with pytest.raises(ValueError, match="CUDA"):
        stark_kernels.blake2s_tree(torch.zeros(64, dtype=torch.int32), 4, 16, 4, 1)
    with pytest.raises(ValueError, match="power of two"):
        tb.tree_strided_plain(torch.zeros(64, dtype=torch.int32), 3, 16, 4, 1)

"""Port vs reference: Blake2s Merkle commitments (zksc_tpu_torch.stark.merkle)
against zksc_tpu.stark.merkle: roots, every opening and verify_path, at 64
leaves of 32 bytes and at 1 leaf, and the column form the prover commits
its LDE with."""
import numpy as np
import pytest
import torch

from zksc_tpu.stark import merkle as jm
from zksc_tpu_torch.stark import blake2s
from zksc_tpu_torch.stark import merkle as tm


@pytest.mark.parametrize("n", [64, 1])
def test_commit_open_verify(n):
    leaves = np.random.default_rng(n).integers(0, 256, (n, 32), dtype=np.uint8)
    ref, got = jm.commit(leaves), tm.commit(leaves, device="cpu")
    assert got.root == ref.root
    assert len(got.layers) == len(ref.layers)
    for i in range(n):
        path = got.open(i)
        assert path == ref.open(i)
        assert tm.verify_path(got.root, i, leaves[i].tobytes(), path)
        assert jm.verify_path(got.root, i, leaves[i].tobytes(), path)
    bad = bytearray(leaves[0].tobytes())
    bad[0] ^= 1
    assert not tm.verify_path(got.root, 0, bytes(bad), got.open(0))
    if n > 1:
        assert not tm.verify_path(got.root, 1, leaves[0].tobytes(), got.open(0))


def test_commit_columns_is_the_transposed_commit():
    """Leaf i of commit_columns is column i of an int32 [C, M] tensor: the
    reference's commit of the rows of its transpose (prover.py:344)."""
    cols = torch.from_numpy(np.random.default_rng(3).integers(
        0, 2**31 - 1, (5, 16)).astype(np.int32))
    rows = np.ascontiguousarray(cols.numpy().T).view(np.uint8).reshape(16, 20)
    assert tm.commit_columns(cols).root == jm.commit(rows).root


def test_node_layers_through_the_strided_hash():
    """The device path's node layers (hash_strided reading cur[2i] ||
    cur[2i+1]) give the host's layers; here with the plain version in
    place of K7a."""
    leaves = np.random.default_rng(5).integers(0, 256, (256, 32), dtype=np.uint8)
    cur = torch.from_numpy(leaves).view(torch.int32)
    digests = blake2s.hash_strided(cur, 256, 32, 8, 1)
    want = jm.commit(leaves)
    layers = [digests]
    while layers[-1].shape[0] > 1:
        layers.append(blake2s.hash_strided(layers[-1], layers[-1].shape[0] // 2,
                                           64, 16, 1))
    for a, b in zip(layers, want.layers):
        np.testing.assert_array_equal(a.numpy().view(np.uint8), b)


def test_commit_refuses_a_ragged_tree():
    with pytest.raises(ValueError, match="power-of-two"):
        tm.commit(np.zeros((3, 32), dtype=np.uint8), device="cpu")

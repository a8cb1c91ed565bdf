"""Blake2s Merkle commitments for the Circle-STARK engine.

Ported from the JAX package's ``stark/merkle.py``: the same layers, root
and openings; paths are checked on the host with hashlib (``verify_path``).

Where the hashing runs:

  - ``commit_columns`` (the trace commitment): the leaves are the columns of
    the prover's [C, M] LDE. On the card K7a's tree launch hashes them
    straight from that tensor (word j of leaf i is lde[j, i]) and every
    node layer above them, in one launch; no transpose, and one copy of
    the layers to the host.
  - ``commit`` (FRI's 16-byte leaves): the same tree launch on the card
    from ``DEVICE_MIN_LEAVES`` leaves, which pay a copy to the card and
    back; hashlib on the host below that.
  - On the CPU, hashlib throughout, as the reference's host path.

The reference sends a tree to the device only from 2^17 leaves, a threshold
set by XLA's compile costs; the crossover here is the card's own (PERF.md).
The digests are the same either way.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .blake2s import tree_strided

# Trees of fewer leaves go to hashlib: chip_smoke.py's phase 3 sweep on one
# H100 (whole trees, the leaves copied from the host and the layers back;
# PERF.md section 6) has the tree launch faster from 64 leaves of 16 bytes
# and of 8 column words.
DEVICE_MIN_LEAVES = 64


@dataclass
class MerkleTree:
    layers: list          # [np.uint8[N_i, 32]] from leaves-hash layer to root

    @property
    def root(self) -> bytes:
        return bytes(self.layers[-1][0].tobytes())

    def open(self, index: int) -> list:
        """Auth path (sibling hashes bottom-up) for a leaf index."""
        path = []
        for layer in self.layers[:-1]:
            sib = index ^ 1
            path.append(bytes(layer[sib].tobytes()))
            index //= 2
        return path


def _check_pow2(n: int):
    if n < 1 or n & (n - 1):
        raise ValueError(f"a Merkle tree needs a power-of-two leaf count, got {n}")


def commit(leaves: np.ndarray, device=None) -> MerkleTree:
    """leaves: uint8[N, leaf_len], N a power of two; hashed on `device`
    (default "cuda") from DEVICE_MIN_LEAVES leaves, on the host below."""
    dev = resolve_device(device)
    n, leaf_len = leaves.shape
    _check_pow2(n)
    if dev.type == "cpu" or n < DEVICE_MIN_LEAVES:
        return _commit_host(leaves)
    nw = -(-leaf_len // 4)
    buf = np.zeros((n, 4 * nw), dtype=np.uint8)
    buf[:, :leaf_len] = leaves
    words = torch.from_numpy(buf.view(np.int32)).to(dev)
    return _tree_device(words, n, leaf_len, nw, 1)


def commit_columns(cols: torch.Tensor) -> MerkleTree:
    """The tree whose leaf i is column i of the int32 [C, M] tensor `cols`
    (its C words, little-endian): K7a's tree launch over the columns in
    place on the card, hashlib over the rows of the transpose on the
    CPU."""
    C, M = cols.shape
    _check_pow2(M)
    if cols.device.type == "cpu":
        rows = np.ascontiguousarray(cols.numpy().T).view(np.uint8)
        return _commit_host(rows.reshape(M, 4 * C))
    return _tree_device(cols.contiguous(), M, 4 * C, 1, M)


def _tree_device(base: torch.Tensor, n: int, length: int, msg_stride: int,
                 word_stride: int) -> MerkleTree:
    """The tree over n strided leaves on the card: one K7a tree launch, its
    layers ([2n - 1, 8] words, back to back) copied to the host once."""
    flat = tree_strided(base, n, length, msg_stride, word_stride)
    flat = flat.cpu().numpy().view(np.uint8)
    layers, at = [], 0
    while n >= 1:
        layers.append(flat[at:at + n])
        at += n
        n //= 2
    return MerkleTree(layers=layers)


def _commit_host(leaves: np.ndarray) -> MerkleTree:
    cur = np.frombuffer(
        b"".join(hashlib.blake2s(leaves[i].tobytes(), digest_size=32).digest()
                 for i in range(leaves.shape[0])), dtype=np.uint8
    ).reshape(-1, 32)
    return MerkleTree(layers=_commit_host_nodes(cur))


def _commit_host_nodes(cur: np.ndarray) -> list:
    layers = [cur]
    while cur.shape[0] > 1:
        nxt = np.frombuffer(
            b"".join(hashlib.blake2s(cur[2 * i].tobytes() + cur[2 * i + 1].tobytes(),
                                     digest_size=32).digest()
                     for i in range(cur.shape[0] // 2)), dtype=np.uint8
        ).reshape(-1, 32)
        layers.append(nxt)
        cur = nxt
    return layers


def verify_path(root: bytes, index: int, leaf: bytes, path: list) -> bool:
    """Host-side path check (verifier)."""
    h = hashlib.blake2s(leaf, digest_size=32).digest()
    for sib in path:
        if index & 1:
            h = hashlib.blake2s(sib + h, digest_size=32).digest()
        else:
            h = hashlib.blake2s(h + sib, digest_size=32).digest()
        index //= 2
    return h == root

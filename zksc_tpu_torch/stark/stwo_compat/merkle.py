"""stwo's lifted Merkle scheme (vcs_lifted) — bit-exact replica.

Validated against reference proofs (NOTES.md):
  leaf(pos)  = blake2s( concat per column: value[pos] as LE u32 )
  node       = blake2s( left || right )
  empty tree = blake2s(b"") (no columns; constant root)
  decommit   = hash witness only, consumed in ascending-position order per
               layer, bottom-up; queried values carried separately.
Stored leaf order is bit-reversed domain order, so fold-sibling pairs are
adjacent (pos 2k, 2k+1).

The host functions are copied from the JAX package's
``stark/stwo_compat/merkle.py``. The prover's trees are the stark engine's
``stark/merkle.MerkleTree`` (the same leaves and nodes: ``commit_columns``
hashes leaf i from column i of a [C, M] tensor, word j at [j, i]), so the
trace tree is K7a over the LDE in place on the card; ``decommit`` takes
their layers as they are.
"""
from __future__ import annotations

import hashlib
import struct

import torch

from .. import merkle as stark_merkle


def _h(b: bytes) -> bytes:
    return hashlib.blake2s(b).digest()


EMPTY_ROOT = _h(b"")


def leaf_hash(values) -> bytes:
    """values: iterable of ints (one per column, M31) at one position."""
    return _h(b"".join(struct.pack("<I", int(v)) for v in values))


def commit(columns) -> tuple:
    """columns: list of equal-length lists (column-major, stored order).
    Returns (root, layers) where layers[0] = leaf hashes."""
    if not columns:
        return EMPTY_ROOT, [[EMPTY_ROOT]]
    n = len(columns[0])
    leaves = [leaf_hash([c[i] for c in columns]) for i in range(n)]
    layers = [leaves]
    cur = leaves
    while len(cur) > 1:
        cur = [_h(cur[i] + cur[i + 1]) for i in range(0, len(cur), 2)]
        layers.append(cur)
    return cur[0], layers


def decommit(layers, positions) -> list:
    """Hash witness for sorted query positions (ascending per layer)."""
    witness = []
    known = sorted(set(positions))
    for layer in layers[:-1]:
        nxt = []
        for pos in known:
            par = pos // 2
            if par in nxt:
                continue
            for child in (par * 2, par * 2 + 1):
                if child not in known:
                    witness.append(bytes(layer[child]))
            nxt.append(par)
        known = nxt
    return witness


def commit_tensor(cols: torch.Tensor) -> stark_merkle.MerkleTree:
    """The tree whose leaf i is column i of the int32 [C, M] tensor `cols`
    (the composition tree's 8 columns): K7a on the card from
    stark_merkle.DEVICE_MIN_LEAVES leaves, hashlib below that and on the
    CPU. The trace tree is ``stark_merkle.commit_columns`` (K7a on the card
    at any size: its leaves are 133,120 B)."""
    if cols.device.type == "cuda" and cols.shape[1] < stark_merkle.DEVICE_MIN_LEAVES:
        cols = cols.cpu()
    return stark_merkle.commit_columns(cols.contiguous())


def verify(leaf_hashes_by_pos: dict, witness: list, depth: int,
           root: bytes) -> bool:
    """Recompute the root from queried leaves + hash witness."""
    wi = 0
    layer = dict(leaf_hashes_by_pos)
    for _ in range(depth):
        nxt = {}
        for pos in sorted(layer):
            par = pos // 2
            if par in nxt:
                continue
            l = layer.get(par * 2)
            r = layer.get(par * 2 + 1)
            if l is None:
                if wi >= len(witness):
                    return False
                l = witness[wi]
                wi += 1
            if r is None:
                if wi >= len(witness):
                    return False
                r = witness[wi]
                wi += 1
            nxt[par] = _h(l + r)
        layer = nxt
    return wi == len(witness) and layer.get(0) == root

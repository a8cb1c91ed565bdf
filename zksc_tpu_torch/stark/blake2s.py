"""Batched Blake2s-256 (RFC 7693): the Merkle hasher of the Circle-STARK
engine.

Ported from the JAX package's ``stark/blake2s.py``: one message per batch
lane, all of one byte length. On a CUDA tensor the hashing goes through
K7a (ops/stark_kernels.blake2s); on a CPU tensor through ``blake2s_plain``,
the same compression on int64 tensors (each holding a uint32 word).

The sources are strided (``hash_strided``): word j of message i is
``base.view(-1)[i * msg_stride + j * word_stride]``, so the prover hashes
the columns of its [C, M] LDE in place. ``tree_strided`` hashes a whole
Merkle tree over such leaves: K7a's tree launch on a CUDA tensor,
``tree_strided_plain`` on a CPU tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import stark_kernels

IV = np.array([
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19], dtype=np.int64)

SIGMA = np.array([
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0]], dtype=np.int64)

MASK = 0xFFFFFFFF


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & MASK


def _g4(a, b, c, d, x, y):
    """Four G functions at once: rows of [4, B] int64 words."""
    a = (a + b + x) & MASK
    d = _rotr(d ^ a, 16)
    c = (c + d) & MASK
    b = _rotr(b ^ c, 12)
    a = (a + b + y) & MASK
    d = _rotr(d ^ a, 8)
    c = (c + d) & MASK
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def _compress(h, m, t: int, last: bool, sigma, iv):
    """h: int64 [8, B]; m: int64 [16, B]; t: the byte counter; sigma, iv:
    SIGMA [10, 16] and IV [8, 1] on h's device."""
    dev = h.device
    a, b = h[:4], h[4:]
    c = iv[:4].expand_as(a)
    tweak = torch.tensor([t & MASK, (t >> 32) & MASK, MASK if last else 0, 0],
                         dtype=torch.int64, device=dev)[:, None]
    d = iv[4:] ^ tweak
    for r in range(10):
        ms = m[sigma[r]]
        a, b, c, d = _g4(a, b, c, d, ms[0:8:2], ms[1:8:2])       # columns
        b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)  # diagonals
        a, b, c, d = _g4(a, b, c, d, ms[8:16:2], ms[9:16:2])
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
    return torch.cat([h[:4] ^ a ^ c, h[4:] ^ b ^ d])


def _to_int32(words):
    """int64 words in [0, 2^32) -> int32 with the same bits."""
    return (((words + (1 << 31)) & MASK) - (1 << 31)).to(torch.int32)


def hash_strided_plain(base: torch.Tensor, count: int, length: int,
                       msg_stride: int, word_stride: int) -> torch.Tensor:
    """Plain PyTorch K7a: Blake2s-256 of `count` messages of `length` bytes
    from the strided int32 source (see the module docstring). Returns int32
    [count, 8], the digests' words."""
    if base.dtype != torch.int32 or not base.is_contiguous():
        raise ValueError("blake2s source: expected a contiguous int32 tensor")
    stark_kernels.check_strided(base, count, length, msg_stride, word_stride,
                                "blake2s")
    dev = base.device
    nw = stark_kernels.n_words(length)
    n_blocks = max(1, -(-length // 64))
    words = torch.zeros((16 * n_blocks, count), dtype=torch.int64, device=dev)
    if count and nw:
        idx = (torch.arange(nw, device=dev)[:, None] * word_stride
               + torch.arange(count, device=dev)[None, :] * msg_stride)
        words[:nw] = base.reshape(-1)[idx].to(torch.int64) & MASK
        tail = length - 4 * (nw - 1)          # bytes of the last word
        if tail < 4:
            words[nw - 1] &= (1 << (8 * tail)) - 1
    sigma = torch.as_tensor(SIGMA, device=dev)
    iv = torch.as_tensor(IV, device=dev)[:, None]
    h = iv.repeat(1, count)
    h[0] ^= 0x01010000 ^ 32                   # parameter block: 32-byte digest
    for blk in range(n_blocks):
        last = blk == n_blocks - 1
        h = _compress(h, words[16 * blk:16 * (blk + 1)],
                      length if last else 64 * (blk + 1), last, sigma, iv)
    return _to_int32(h.T.contiguous())


def hash_strided(base: torch.Tensor, count: int, length: int, msg_stride: int,
                 word_stride: int) -> torch.Tensor:
    """Blake2s-256 of `count` strided messages: K7a on a CUDA tensor, the
    plain version on a CPU tensor."""
    if base.device.type == "cpu":
        return hash_strided_plain(base, count, length, msg_stride, word_stride)
    return stark_kernels.blake2s(base, count, length, msg_stride, word_stride)


def tree_strided_plain(base: torch.Tensor, count: int, length: int,
                       msg_stride: int, word_stride: int) -> torch.Tensor:
    """Plain PyTorch version of K7a's tree launch: the leaf digests of the
    `count` (a power of two) strided messages, then each node layer
    (Blake2s of the two children's 64 bytes) up to the root. Returns int32
    [2 * count - 1, 8], the layers back to back."""
    if count < 1 or count & (count - 1):
        raise ValueError(f"blake2s_tree: {count} leaves is not a power of two")
    return tree_from_leaves_plain(
        hash_strided_plain(base, count, length, msg_stride, word_stride))


def tree_from_leaves_plain(leaves: torch.Tensor) -> torch.Tensor:
    """The leaf digests (int32 [N, 8]) and every node layer above them, up
    to the root, back to back: int32 [2N - 1, 8]."""
    layers = [leaves]
    while layers[-1].shape[0] > 1:
        cur = layers[-1]
        layers.append(hash_strided_plain(cur, cur.shape[0] // 2, 64, 16, 1))
    return torch.cat(layers)


def tree_strided(base: torch.Tensor, count: int, length: int, msg_stride: int,
                 word_stride: int) -> torch.Tensor:
    """The Merkle tree over `count` strided leaves as int32 [2 * count - 1,
    8]: K7a's tree launch on a CUDA tensor, the plain version on a CPU
    tensor."""
    if base.device.type == "cpu":
        return tree_strided_plain(base, count, length, msg_stride, word_stride)
    return stark_kernels.blake2s_tree(base, count, length, msg_stride,
                                      word_stride)


def _words_of(data: torch.Tensor, length: int) -> torch.Tensor:
    """uint8 [B, >= length] -> int32 [B, ceil(length / 4)] (zero-padded)."""
    if data.dtype != torch.uint8 or data.dim() != 2 or data.shape[1] < length:
        raise ValueError(f"blake2s: expected uint8 [B, >= {length}], got "
                         f"{data.dtype} {tuple(data.shape)}")
    nw = stark_kernels.n_words(length)
    if nw == 0:
        return torch.zeros((data.shape[0], 0), dtype=torch.int32,
                           device=data.device)
    buf = torch.zeros((data.shape[0], 4 * nw), dtype=torch.uint8,
                      device=data.device)
    buf[:, :length] = data[:, :length]
    return buf.view(torch.int32)


def blake2s(data: torch.Tensor, length: int) -> torch.Tensor:
    """Blake2s-256 of uint8 [B, length] -> uint8 [B, 32]."""
    words = _words_of(data, length)
    out = hash_strided(words, data.shape[0], length, words.shape[1], 1)
    return out.view(torch.uint8)


def blake2s_plain(data: torch.Tensor, length: int) -> torch.Tensor:
    """The plain version of ``blake2s`` on any device."""
    words = _words_of(data, length)
    out = hash_strided_plain(words, data.shape[0], length, words.shape[1], 1)
    return out.view(torch.uint8)


def blake2s_pair(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Merkle node hash: uint8 [B, 32] x2 -> uint8 [B, 32]."""
    return blake2s(torch.cat([left, right], dim=1), 64)

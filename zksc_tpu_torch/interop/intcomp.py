"""Decoder for gnark's packed-integer streams (ronanh/intcomp wire format).

gnark v0.14 compresses the large integer slices of a serialized constraint
system (instruction columns, level lists) with github.com/ronanh/intcomp —
delta encoding + binary bit-packing in fixed-size blocks, with a varint tail
for the remainder. The byte format here was reverse-engineered from the
reference's shipped artifacts (resources/gnark/r1cs.*) and
validated value-exactly against independent ground truth recovered from the
same files (the varint CallData section: record lengths == StartCallData
deltas, R1C/hint record structure == BlueprintID / ConstraintOffset columns).

Stream layout (all words little-endian):

  uint32 stream:
    [0] nPacked            number of values in bit-packed blocks (×128)
    [1] tailOff            word index where the tail section starts
    [2] base               delta seed; first block's first delta is
                           (value[0] - base), encoders emit base = value[0]
    [3:tailOff]            blocks: 1 header word + payload
                           header byte (3-g) = group g's width byte:
                             bit7 = zigzag flag, bits0-6 = bit width
                           each of 4 groups packs 32 deltas LSB-first into
                           `width` payload words
    [tailOff]   tailCount  number of remaining values (< 128)
    [tailOff+1] T          tail section length in words (count+len+data)
    [tailOff+2 : tailOff+T] LEB128 varints, bytes big-endian *within* each
                           word: first value absolute, rest deltas
    [tailOff+T] T          suffix copy of T (enables back-to-front scans)

  uint64 stream: same shape with u64 words; (nPacked, tailOff) and
  (tailCount, T) each pack into one u64 as (lo32, hi32); blocks hold
  4 groups of 64 deltas (256 values per block).

Empty arrays serialize as [0, 2?]-style headers with tailCount == 0; the
decoder handles any tailCount/nPacked combination defensively.
"""
from __future__ import annotations

import numpy as np

__all__ = ["decompress_uint32", "decompress_uint64"]


def _varints(data: bytes, count: int) -> list[int]:
    """Decode `count` LEB128 varints from data."""
    out = []
    v = 0
    s = 0
    for b in data:
        v |= (b & 0x7F) << s
        s += 7
        if b < 0x80:
            out.append(v)
            v = 0
            s = 0
            if len(out) == count:
                break
    if len(out) != count:
        raise ValueError(f"varint tail truncated: {len(out)} < {count}")
    return out


def _unpack_group(payload: np.ndarray, width: int, lanes: int,
                  word_bits: int) -> np.ndarray:
    """LSB-first unpack of `lanes` fixed-width values from payload words."""
    total = lanes * width
    # bit matrix [total]: bit i of the contiguous stream
    words = payload.astype(np.uint64)
    idx = np.arange(total, dtype=np.int64)
    w = idx // word_bits
    b = idx % word_bits
    bits = (words[w] >> b.astype(np.uint64)) & 1
    bits = bits.reshape(lanes, width)
    weights = (np.uint64(1) << np.arange(width, dtype=np.uint64))
    return (bits * weights).sum(axis=1, dtype=np.uint64)


def _zigzag(v: np.ndarray) -> np.ndarray:
    return (v >> np.uint64(1)) ^ (~(v & np.uint64(1)) + np.uint64(1))


def _decompress(words: np.ndarray, word_bits: int, lanes: int):
    mask_lo = (1 << 32) - 1
    if word_bits == 64:
        h0 = int(words[0])
        n_packed, tail_off = h0 & mask_lo, h0 >> 32
        base_idx = 1
    else:
        n_packed, tail_off = int(words[0]), int(words[1])
        base_idx = 2
    # Arrays with no full block serialize as a bare varint tail chunk
    # ([count][T][data][T]); packed chunks always hold a positive multiple
    # of the block size, which disambiguates the two headers.
    if n_packed % (4 * lanes) != 0 or n_packed == 0:
        n_packed, tail_off = 0, 0

    block = 4 * lanes
    n_alloc = ((n_packed + block - 1) // block) * block
    deltas = np.zeros(n_alloc, dtype=np.uint64)
    pos = 0
    i = base_idx
    prev = np.uint64(0)
    if n_packed:
        prev = np.uint64(words[base_idx])
        i = base_idx + 1
        while pos < n_packed:
            hdr = int(words[i]); i += 1
            for g in range(4):
                wb = (hdr >> (8 * (3 - g))) & 0xFF
                zz, width = wb & 0x80, wb & 0x7F
                if width == 0:
                    pos += lanes
                    continue
                payload = words[i:i + width]; i += width
                vals = _unpack_group(payload, width, lanes, word_bits)
                if zz:
                    vals = _zigzag(vals)
                deltas[pos:pos + lanes] = vals
                pos += lanes
    deltas = deltas[:n_packed]
    if n_packed and i != tail_off:
        raise ValueError(f"packed area misparse: ended at {i}, tail at {tail_off}")

    if n_packed:
        out = prev + np.cumsum(deltas, dtype=np.uint64)
        if word_bits == 32:
            out = out & np.uint64(0xFFFFFFFF)
    else:
        out = np.zeros(0, dtype=np.uint64)

    # tail. When the value count is an exact multiple of the block size the
    # tail degenerates: either nothing, or a single suffix word (== tail_off)
    # kept for backward scans.
    if n_packed and tail_off + 1 >= len(words):
        return out, len(words)
    if word_bits == 64:
        th = int(words[tail_off])
        tail_count, t_len = th & mask_lo, th >> 32
        if tail_count == 0:
            return out, tail_off + 1
        data_words = words[tail_off + 1: tail_off + t_len]
        data = data_words.astype(">u8").tobytes()
    else:
        tail_count = int(words[tail_off])
        if tail_count == 0:
            return out, tail_off + 1
        t_len = int(words[tail_off + 1])
        data_words = words[tail_off + 2: tail_off + t_len]
        data = data_words.astype(">u4").tobytes()
    end = tail_off + t_len + 1
    if tail_count:
        tv = _varints(data, tail_count)
        tail = np.cumsum(np.asarray(tv, dtype=np.uint64), dtype=np.uint64)
        if word_bits == 32:
            tail = tail & np.uint64(0xFFFFFFFF)
        out = np.concatenate([out, tail])
    return out, end


def decompress_uint32(words: np.ndarray) -> tuple[np.ndarray, int]:
    """words: uint32 array starting at the stream header. Returns
    (values uint64 array, words consumed)."""
    return _decompress(np.asarray(words, dtype=np.uint32), 32, 32)


def decompress_uint64(words: np.ndarray) -> tuple[np.ndarray, int]:
    """words: uint64 array starting at the stream header. Returns
    (values uint64 array, words consumed)."""
    return _decompress(np.asarray(words, dtype=np.uint64), 64, 64)

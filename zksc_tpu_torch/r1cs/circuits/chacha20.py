"""ChaCha20 R1CS circuit (bit-level, multi-block, per-block nonce+counter).

Statement (matches the reference's gnark chachaV3 semantics, studied at
gnark/circuits/chachaV3/common.go:17-59 — re-derived here, not translated):
prover knows a 256-bit key such that for each of B blocks,
ChaCha20-block(key, nonce_b, counter_b) XOR in_b == out_b, where nonce/counter
/in/out are public per block. RFC 7539 block function, 10 double rounds.

Bit conventions: every 32-bit word is a list of 32 Vars, LSB first; word w of
a byte stream is the little-endian u32 of bytes 4w..4w+3 (so circuit bits align
with RFC 7539 serialization with zero rewiring).

Counts (B=2): ~44.6K constraints, fits a 2^16 NTT domain.
"""
from __future__ import annotations

CHACHA_CONSTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
BLOCK_BITS = 512
KEY_BITS = 256
NONCE_BITS = 96
COUNTER_BITS = 32
DEFAULT_BLOCKS = 2    # one proof covers a 128-byte chunk, like the reference


def public_layout(blocks: int = DEFAULT_BLOCKS):
    layout = []
    for b in range(blocks):
        layout += [
            (f"counter{b}", COUNTER_BITS),
            (f"nonce{b}", NONCE_BITS),
            (f"in{b}", BLOCK_BITS),
            (f"out{b}", BLOCK_BITS),
        ]
    return layout


def private_layout(blocks: int = DEFAULT_BLOCKS):
    return [("key", KEY_BITS)]


def _add32(api, a_bits, b_bits):
    """32-bit modular addition: pack, add, redecompose to 33 bits, drop carry."""
    s = api.add(api.from_bits(a_bits), api.from_bits(b_bits))
    return api.to_bits(s, 33)[:32]


def _xor_word(api, a_bits, b_bits):
    return [api.xor(a, b) for a, b in zip(a_bits, b_bits)]


def _rotl(bits, n):
    """Left-rotate a (LSB-first) 32-bit word: bit i of result = bit (i-n) mod 32."""
    return [bits[(i - n) % 32] for i in range(32)]


def _quarter_round(api, a, b, c, d):
    a = _add32(api, a, b)
    d = _rotl(_xor_word(api, d, a), 16)
    c = _add32(api, c, d)
    b = _rotl(_xor_word(api, b, c), 12)
    a = _add32(api, a, b)
    d = _rotl(_xor_word(api, d, a), 8)
    c = _add32(api, c, d)
    b = _rotl(_xor_word(api, b, c), 7)
    return a, b, c, d


_QR_COLS = [(0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15)]
_QR_DIAG = [(0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14)]


def _const_word(api, value: int):
    return [api.constant((value >> i) & 1) for i in range(32)]


def bytes_to_bits(data: bytes) -> list:
    """Byte stream -> bit list in the circuit's convention (LSB-first per byte,
    which equals LSB-first bits of LE-packed u32 words)."""
    return [(byte >> i) & 1 for byte in data for i in range(8)]


def bits_to_bytes(bits: list) -> bytes:
    assert len(bits) % 8 == 0
    return bytes(sum(int(bits[8 * p + i]) << i for i in range(8))
                 for p in range(len(bits) // 8))


def witness_inputs(keys: list, block_infos: list, ins: list, outs: list,
                   blocks: int = DEFAULT_BLOCKS):
    """Build (public_values, private_values) dicts for a batch of proofs.

    keys: [batch] of 32-byte keys; block_infos: [batch][blocks] of
    (nonce12, counter int); ins/outs: [batch][blocks] of 64-byte blocks.
    Value arrays are [count][batch] int lists as generate_witness expects.
    """
    import struct
    batch = len(keys)
    pub, priv = {}, {}
    priv["key"] = _transpose([bytes_to_bits(k) for k in keys], KEY_BITS, batch)
    for b in range(blocks):
        pub[f"counter{b}"] = _transpose(
            [bytes_to_bits(struct.pack("<I", block_infos[j][b][1]))
             for j in range(batch)], COUNTER_BITS, batch)
        pub[f"nonce{b}"] = _transpose(
            [bytes_to_bits(block_infos[j][b][0]) for j in range(batch)],
            NONCE_BITS, batch)
        pub[f"in{b}"] = _transpose(
            [bytes_to_bits(ins[j][b]) for j in range(batch)], BLOCK_BITS, batch)
        pub[f"out{b}"] = _transpose(
            [bytes_to_bits(outs[j][b]) for j in range(batch)], BLOCK_BITS, batch)
    return pub, priv


def _transpose(rows: list, count: int, batch: int) -> list:
    assert len(rows) == batch and all(len(r) == count for r in rows)
    return [[rows[j][i] for j in range(batch)] for i in range(count)]


def make_define(blocks: int = DEFAULT_BLOCKS):
    def define(api, v):
        key = v["key"]
        for kb in key:
            api.assert_bool(kb)
        key_words = [key[32 * w: 32 * w + 32] for w in range(8)]
        for b in range(blocks):
            counter = v[f"counter{b}"]
            nonce = v[f"nonce{b}"]
            nonce_words = [nonce[32 * w: 32 * w + 32] for w in range(3)]
            init = ([_const_word(api, c) for c in CHACHA_CONSTS]
                    + key_words + [counter] + nonce_words)
            st = list(init)
            for _ in range(10):
                for (ia, ib, ic, id_) in _QR_COLS:
                    st[ia], st[ib], st[ic], st[id_] = _quarter_round(
                        api, st[ia], st[ib], st[ic], st[id_])
                for (ia, ib, ic, id_) in _QR_DIAG:
                    st[ia], st[ib], st[ic], st[id_] = _quarter_round(
                        api, st[ia], st[ib], st[ic], st[id_])
            ks = [_add32(api, st[w], init[w]) for w in range(16)]
            inb = v[f"in{b}"]
            outb = v[f"out{b}"]
            for w in range(16):
                for j in range(32):
                    api.xor_constrain(ks[w][j], inb[32 * w + j], outb[32 * w + j])
    return define

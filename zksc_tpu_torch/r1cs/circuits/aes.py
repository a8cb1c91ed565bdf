"""AES-128/256-CTR R1CS circuit (bit-level, sound S-box).

Statement (parity with the reference's gnark aesV2 semantics, studied at
gnark/circuits/aesV2/common.go:60-73 — designed fresh): prover knows the AES
key such that for each of B blocks, AES-Enc(key, nonce||BE32(counter_b)) XOR
in_b == out_b, with nonce/counter/in/out public per block. In-circuit key
expansion; round keys shared across blocks.

Unlike the reference's circom AES (unconstrained T-table hints, flagged
"may be insecure" in its own readme — SURVEY.md §2.2), the S-box here is fully
constrained: SubBytes(x) = affine(inv(x)) with the GF(2^8) inverse supplied as
a hint and bound by x*v == 1-z, x*z == 0, z boolean (z = [x==0]), then the
GF(2)-affine map as xor chains over the inverse's bits.

A byte is a list of 8 bit Vars, LSB first; the 16-byte block is in stream
order (AES state column-major = byte order of the stream).
~12.5K constraints per block + ~3K key expansion; 5 blocks ≈ 66K (AES-128).
"""
from __future__ import annotations

import numpy as np

from ...ops.ciphers import AES_GF_INV, AES_RCON

BLOCK_BITS = 128
NONCE_BITS = 96
COUNTER_BITS = 32
DEFAULT_BLOCKS = 5    # 80-byte chunk, like the reference


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


def private_layout(blocks: int = DEFAULT_BLOCKS, key_bits: int = 128):
    return [("key", key_bits)]


# ---- byte helpers (byte = [8 bit Vars], LSB first) ----

def _xor_byte(api, A, B):
    return [api.xor(a, b) for a, b in zip(A, B)]


def _xor_const_byte(api, A, c: int):
    """XOR with a constant byte is linear: bit -> 1-bit where c has a 1."""
    one = api.constant(1)
    return [api.sub(one, a) if (c >> i) & 1 else a for i, a in enumerate(A)]


def _xtime(api, A):
    """GF(2^8) multiply by 2: shift + conditional 0x1B, 3 xors."""
    b7 = A[7]
    return [b7, api.xor(A[0], b7), A[1], api.xor(A[2], b7),
            api.xor(A[3], b7), A[4], A[5], A[6]]


def _sbox_hint(x_vals):
    """Witness hint: x (byte value) -> [inv bits (8), is_zero] (9 outputs)."""
    outs = []
    for i in range(8):
        outs.append(np.asarray([(int(AES_GF_INV[int(v)]) >> i) & 1
                                for v in x_vals], dtype=object))
    outs.append(np.asarray([1 if int(v) == 0 else 0 for v in x_vals],
                           dtype=object))
    return outs


# Static fold map for GF(2^8) reduction mod x^8+x^4+x^3+x+1: column k of the
# carryless product contributes (mod 2) to result bits fold_targets[k].
def _fold_targets():
    # start with identity for k<8; for k>=8 fold into k-8 + {0,1,3,4}, cascade
    contrib = [[0] * 8 for _ in range(15)]     # contrib[k][j] = multiplicity
    pending = [[1 if k == j else 0 for j in range(15)] for k in range(15)]
    # pending[k] = expansion of column k over columns; cascade high columns
    for k in range(14, 7, -1):
        for tgt in (k - 8, k - 8 + 1, k - 8 + 3, k - 8 + 4):
            for j in range(15):
                pending[tgt][j] ^= pending[k][j]
        pending[k] = [0] * 15
    # now pending[j] (j<8) says which original columns XOR into result bit j
    return [[k for k in range(15) if pending[j][k]] for j in range(8)]


_FOLD = _fold_targets()


def _parity(api, bits):
    """XOR of a list of bit Vars via integer sum + 4-bit decomposition."""
    if len(bits) == 1:
        return bits[0]
    s = api.add(*bits)
    width = max(2, len(bits).bit_length())
    return api.to_bits(s, width)[0]


def _sbox(api, X):
    """SubBytes: s = affine(inv(x)), fully constrained.

    The GF(2^8) inverse v is hinted (as bits) and bound by a carryless
    multiplication check done in ONE field multiply: bits spread 4 apart so
    convolution columns can't carry (column sums <= 8 < 16); the product's
    4-bit groups are recovered with to_bits, group LSBs are the column
    parities, and a static fold mod the AES polynomial must equal 1 - is_zero.
    """
    one = api.constant(1)
    x_packed = api.from_bits(X)
    hints = api.hint(_sbox_hint, [x_packed], 9)
    vb, z = hints[:8], hints[8]
    for b in vb:
        api.assert_bool(b)
    api.assert_bool(z)
    api.mul_eq(x_packed, z, api.constant(0))          # z==1 -> x==0
    # spread operands: sum_i b_i * 16^i (linear)
    x_spread = api.add(*[api.mul_const(X[i], 1 << (4 * i)) for i in range(8)])
    v_spread = api.add(*[api.mul_const(vb[i], 1 << (4 * i)) for i in range(8)])
    # Bind the hint when x == 0: with z==1 the product check below is vacuous
    # (x_spread == 0 kills prod for ANY v), so force v == 0 there; the affine
    # map then yields S(0) = 0x63 as required. v_spread is a carry-free sum of
    # boolean bits at distinct 16^i weights, so v_spread == 0 iff all bits 0.
    api.mul_eq(v_spread, z, api.constant(0))
    prod = api.mul(x_spread, v_spread)
    pb = api.to_bits(prod, 60)                        # 15 columns x 4 bits
    col_parity = [pb[4 * k] for k in range(15)]
    # gf_mul(x, v) must equal 1 - z (i.e. 1 if x != 0, else 0)
    for j in range(8):
        r_j = _parity(api, [col_parity[k] for k in _FOLD[j]])
        api.assert_eq(r_j, api.sub(one, z) if j == 0 else api.constant(0))
    # affine: s_i = v_i ^ v_{i+4} ^ v_{i+5} ^ v_{i+6} ^ v_{i+7} ^ c_i, c=0x63
    out = []
    for i in range(8):
        t = _parity(api, [vb[i], vb[(i + 4) % 8], vb[(i + 5) % 8],
                          vb[(i + 6) % 8], vb[(i + 7) % 8]])
        if (0x63 >> i) & 1:
            t = api.sub(one, t)
        out.append(t)
    return out


_SHIFT_IDX = [0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11]


def _mix_column(api, col):
    a0, a1, a2, a3 = col
    x0, x1, x2, x3 = (_xtime(api, a) for a in (a0, a1, a2, a3))
    def x3b(x, a):  # xtime(a) ^ a
        return _xor_byte(api, x, a)
    r0 = _xor_byte(api, _xor_byte(api, x0, x3b(x1, a1)), _xor_byte(api, a2, a3))
    r1 = _xor_byte(api, _xor_byte(api, a0, x1), _xor_byte(api, x3b(x2, a2), a3))
    r2 = _xor_byte(api, _xor_byte(api, a0, a1), _xor_byte(api, x2, x3b(x3, a3)))
    r3 = _xor_byte(api, _xor_byte(api, x3b(x0, a0), a1), _xor_byte(api, a2, x3))
    return [r0, r1, r2, r3]


def _expand_key(api, key_bytes, rounds: int):
    """In-circuit key schedule; key_bytes: 16 or 32 bytes -> (rounds+1)x16."""
    nk = len(key_bytes) // 4
    words = [key_bytes[4 * i: 4 * i + 4] for i in range(nk)]
    for i in range(nk, 4 * (rounds + 1)):
        temp = words[i - 1]
        if i % nk == 0:
            temp = [temp[1], temp[2], temp[3], temp[0]]       # RotWord
            temp = [_sbox(api, b) for b in temp]              # SubWord
            temp = [_xor_const_byte(api, temp[0], int(AES_RCON[i // nk - 1]))] \
                + temp[1:]
        elif nk > 6 and i % nk == 4:
            temp = [_sbox(api, b) for b in temp]
        words.append([_xor_byte(api, a, b) for a, b in zip(words[i - nk], temp)])
    return [sum((words[4 * r + c] for c in range(4)), [])
            for r in range(rounds + 1)]


def make_define(blocks: int = DEFAULT_BLOCKS, key_bits: int = 128):
    rounds = {128: 10, 256: 14}[key_bits]

    def define(api, v):
        key = v["key"]
        for kb in key:
            api.assert_bool(kb)
        key_bytes = [key[8 * p: 8 * p + 8] for p in range(key_bits // 8)]
        round_keys = _expand_key(api, key_bytes, rounds)

        for b in range(blocks):
            counter = v[f"counter{b}"]
            nonce = v[f"nonce{b}"]
            # counter block: 12 nonce bytes + BE32 counter
            ctr_bytes = [counter[24:32], counter[16:24], counter[8:16],
                         counter[0:8]]
            state = [nonce[8 * p: 8 * p + 8] for p in range(12)] + ctr_bytes
            # AddRoundKey 0
            state = [_xor_byte(api, sb, rk)
                     for sb, rk in zip(state, round_keys[0])]
            for rnd in range(1, rounds + 1):
                state = [_sbox(api, sb) for sb in state]
                state = [state[i] for i in _SHIFT_IDX]
                if rnd != rounds:
                    cols = [state[4 * c: 4 * c + 4] for c in range(4)]
                    state = sum((_mix_column(api, col) for col in cols), [])
                state = [_xor_byte(api, sb, rk)
                         for sb, rk in zip(state, round_keys[rnd])]
            # keystream XOR in == out (public binding, no new wires)
            inb = v[f"in{b}"]
            outb = v[f"out{b}"]
            for p in range(16):
                for i in range(8):
                    api.xor_constrain(state[p][i], inb[8 * p + i],
                                      outb[8 * p + i])
    return define


def bytes_to_bits(data: bytes) -> list:
    return [(byte >> i) & 1 for byte in data for i in range(8)]


def witness_inputs(keys: list, block_infos: list, ins: list, outs: list,
                   blocks: int = DEFAULT_BLOCKS):
    """Same shape as chacha20.witness_inputs, 16-byte blocks."""
    import struct
    batch = len(keys)
    key_bits = len(keys[0]) * 8
    pub, priv = {}, {}
    priv["key"] = _transpose([bytes_to_bits(k) for k in keys], key_bits, batch)
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

"""ChaCha20 stream AIR: trace layout, trace generation, constraint indices.

A copy of the JAX package's ``stark/chacha_air.py`` (numpy on the host).

TPU-native re-design of stwo's production ChaCha stream AIR (reference
behavior studied at stwo/src/chacha/bitwise/constraints_stream.rs:20-69 and
gen_stream.rs:118-171; implemented fresh): one trace ROW = one 64-byte ChaCha
block (the row axis is the batch axis — the TPU analogue of stwo's 16-lane
SIMD rows), columns are bits. Statement per row:

    chacha20_block(key, nonce, counter0 + row) XOR plaintext == ciphertext

with nonce/counter/ciphertext PUBLIC and key/plaintext private.

Differences from the reference (deliberate, stronger binding):
  - The reference commits ciphertext/nonce/counter as ordinary trace columns
    and binds them to the verifier's values only through Fiat-Shamir hash
    mixing. Here they are PUBLIC COLUMNS: never committed, evaluated by the
    verifier itself, so the proof is algebraically bound to the exact public
    ciphertext (padding rows use plaintext=keystream => ciphertext column 0,
    mirroring wasm_api.rs padding-lane behavior with pt/ct swapped).
  - XOR outputs that are only ever used linearly (the last double-round's
    trailing xor-rotls feeding the final keystream adds) are VIRTUAL:
    expressed in-constraint, never committed (256 columns saved).

Constraint groups (all degree <= 2; combined with alpha powers in the fixed
order bool, add, addx, xor, eq — see stark/prover.py):
  bool:  b * (1 - b) = 0                    for every committed column
  add:   r_i + 2 c_i - a_i - b_i - c_{i-1} = 0   (ripple-carry, c_{-1} = 0)
  addx:  same with operand a_i = u_i + w_i - 2 u_i w_i (virtual xor)
  xor:   r_i - a_s - b_s + 2 a_s b_s = 0    (s = rotation source bit)
  eq:    ks_i + p_i - 2 ks_i p_i - ct_i = 0 (ciphertext binding, ct public)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

CHACHA_CONSTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
QR_COLS = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15))
QR_DIAGS = ((0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))

# public column layout: consts 4*32 | counter 32 | nonce 3*32 | ct 16*32
N_PUBLIC = 4 * 32 + 32 + 3 * 32 + 16 * 32      # 768


@dataclass
class Word:
    """A 32-bit value as bit handles, LSB first. Each bit is an int ref
    (column index) or a ('x', u, w) virtual-xor of two refs."""
    bits: list


def _xor_bit(u, w):
    return ("x", u, w)


class IndexWalker:
    """Builds committed-column count + constraint index groups."""

    def __init__(self):
        self.n_committed = 0
        self.bool_refs: list = []
        self.add = {k: [] for k in ("A", "B", "R", "C", "Cin")}
        self.addx = {k: [] for k in ("U", "W", "B", "R", "C", "Cin")}
        self.xor = {k: [] for k in ("A", "B", "R")}
        self.eq = {k: [] for k in ("KS", "PT", "CT")}

    # refs: committed cols first, then public cols, then the zero column
    def _pub(self, idx: int) -> int:
        return -(idx + 1)           # resolved to n_committed + idx later

    def _alloc_u32(self) -> Word:
        bits = list(range(self.n_committed, self.n_committed + 32))
        self.n_committed += 32
        self.bool_refs.extend(bits)
        return Word(bits)

    def public_u32(self, pub_word: int) -> Word:
        return Word([self._pub(32 * pub_word + i) for i in range(32)])

    def alloc_input_u32(self) -> Word:
        return self._alloc_u32()

    def add32(self, x: Word, y: Word) -> Word:
        r = self._alloc_u32()
        carries = list(range(self.n_committed, self.n_committed + 32))
        self.n_committed += 32
        self.bool_refs.extend(carries)
        x_virtual = any(isinstance(b, tuple) for b in x.bits)
        assert not any(isinstance(b, tuple) for b in y.bits) or not x_virtual
        y_virtual = any(isinstance(b, tuple) for b in y.bits)
        for i in range(32):
            cin = self.ZERO if i == 0 else carries[i - 1]
            if x_virtual or y_virtual:
                v, o = (x.bits[i], y.bits[i]) if x_virtual else (y.bits[i], x.bits[i])
                if isinstance(v, tuple):
                    _, u, w = v
                    self.addx["U"].append(u)
                    self.addx["W"].append(w)
                    self.addx["B"].append(o)
                else:                        # mixed word: plain bit
                    self.addx["U"].append(v)
                    self.addx["W"].append(self.ZERO)
                    self.addx["B"].append(o)
                self.addx["R"].append(r.bits[i])
                self.addx["C"].append(carries[i])
                self.addx["Cin"].append(cin)
            else:
                self.add["A"].append(x.bits[i])
                self.add["B"].append(y.bits[i])
                self.add["R"].append(r.bits[i])
                self.add["C"].append(carries[i])
                self.add["Cin"].append(cin)
        return r

    def xorrot32(self, x: Word, y: Word, rot: int, virtual: bool = False) -> Word:
        if virtual:
            return Word([_xor_bit(x.bits[(i - rot) % 32], y.bits[(i - rot) % 32])
                         for i in range(32)])
        r = self._alloc_u32()
        for i in range(32):
            src = (i - rot) % 32
            self.xor["A"].append(x.bits[src])
            self.xor["B"].append(y.bits[src])
            self.xor["R"].append(r.bits[i])
        return r

    def eq_bind(self, ks: Word, pt: Word, ct: Word):
        for i in range(32):
            self.eq["KS"].append(ks.bits[i])
            self.eq["PT"].append(pt.bits[i])
            self.eq["CT"].append(ct.bits[i])

    ZERO = "Z"

    def finish(self):
        """Resolve public/zero refs to value-matrix rows
        [committed | public | zero]."""
        C = self.n_committed
        zero_ref = C + N_PUBLIC

        def fix(r):
            if r == self.ZERO:
                return zero_ref
            return C + (-r - 1) if isinstance(r, int) and r < 0 else r

        groups = {}
        groups["bool"] = np.asarray([fix(r) for r in self.bool_refs], np.int32)
        for name, g in (("add", self.add), ("addx", self.addx),
                        ("xor", self.xor), ("eq", self.eq)):
            groups[name] = {k: np.asarray([fix(r) for r in v], np.int32)
                            for k, v in g.items()}
        return groups


class TraceWalker:
    """Computes the committed trace [n_committed, rows] (numpy uint32 bits).

    Word values ride along as uint32[rows]; allocation order must mirror
    IndexWalker exactly (shared _walk driver below guarantees it)."""

    def __init__(self, rows: int, public_words: np.ndarray):
        self.rows = rows
        self.cols: list = []
        self.public_words = public_words          # [20] words or [20, rows]

    def public_u32(self, pub_word: int) -> Word:
        w = self.public_words[pub_word]
        val = np.broadcast_to(np.asarray(w, np.uint32), (self.rows,)) \
            if np.ndim(w) == 0 else w.astype(np.uint32)
        word = Word([None] * 32)
        word.value = val
        return word

    def _push_word_bits(self, val: np.ndarray) -> Word:
        w = Word([None] * 32)
        w.value = val.astype(np.uint32)
        for i in range(32):
            self.cols.append(((val >> i) & 1).astype(np.uint32))
        return w

    def alloc_input_u32(self, value: np.ndarray = None) -> Word:
        return self._push_word_bits(value)

    def add32(self, x: Word, y: Word) -> Word:
        t = x.value.astype(np.uint64) + y.value.astype(np.uint64)
        s = (t & 0xFFFFFFFF).astype(np.uint32)
        cin = (t ^ x.value ^ y.value) & 0xFFFFFFFF   # carry-ins per bit
        k = ((cin >> 1) | ((t >> 32) << 31)).astype(np.uint32)  # carry-outs
        r = self._push_word_bits(s)
        for i in range(32):                            # carry columns
            self.cols.append(((k >> i) & 1).astype(np.uint32))
        return r

    def xorrot32(self, x: Word, y: Word, rot: int, virtual: bool = False) -> Word:
        v = x.value ^ y.value
        val = ((v << rot) | (v >> (32 - rot))) & 0xFFFFFFFF if rot else v
        val = val.astype(np.uint32)
        if virtual:
            w = Word([None] * 32)
            w.value = val
            return w
        return self._push_word_bits(val)

    def eq_bind(self, ks: Word, pt: Word, ct: Word):
        assert np.array_equal(ks.value ^ pt.value, ct.value), \
            "witness does not satisfy: keystream ^ plaintext != ciphertext"

    def finish(self) -> np.ndarray:
        return np.stack(self.cols)                    # [n_committed, rows]


def _walk(b, key_words=None, pt_words=None):
    """Shared circuit walk. key_words/pt_words only used by TraceWalker."""
    is_trace = isinstance(b, TraceWalker)
    state = []
    for i in range(4):
        state.append(b.public_u32(i))                 # constants
    for i in range(8):
        state.append(b.alloc_input_u32(key_words[i]) if is_trace
                     else b.alloc_input_u32())        # key
    state.append(b.public_u32(4))                     # counter
    for i in range(3):
        state.append(b.public_u32(5 + i))             # nonce
    init = list(state)
    v = list(state)
    for dr in range(10):
        last = dr == 9
        for qr_set, diag in ((QR_COLS, False), (QR_DIAGS, True)):
            for (a, bb, c, d) in qr_set:
                v[a] = b.add32(v[a], v[bb])
                v[d] = b.xorrot32(v[a], v[d], 16)
                v[c] = b.add32(v[c], v[d])
                v[bb] = b.xorrot32(v[c], v[bb], 12)
                v[a] = b.add32(v[a], v[bb])
                v[d] = b.xorrot32(v[a], v[d], 8, virtual=last and diag)
                v[c] = b.add32(v[c], v[d])
                v[bb] = b.xorrot32(v[c], v[bb], 7, virtual=last and diag)
    ks = [b.add32(v[i], init[i]) for i in range(16)]
    pt = [b.alloc_input_u32(pt_words[i]) if is_trace else b.alloc_input_u32()
          for i in range(16)]
    for i in range(16):
        b.eq_bind(ks[i], pt[i], b.public_u32(8 + i))
    return b.finish()


_LAYOUT_CACHE = {}


def layout():
    """(n_committed, groups) for the ChaCha stream AIR (cached)."""
    if "v" not in _LAYOUT_CACHE:
        w = IndexWalker()
        groups = _walk(w)
        _LAYOUT_CACHE["v"] = (w.n_committed, groups)
    return _LAYOUT_CACHE["v"]


def public_words(nonce: bytes, counter0: int, ct_rows: np.ndarray,
                 rows: int) -> np.ndarray:
    """Public word values [24 words][rows]: consts, counter (per-row
    sequential), nonce, 16 ciphertext words."""
    out = np.zeros((24, rows), dtype=np.uint32)
    for i in range(4):
        out[i] = CHACHA_CONSTS[i]
    out[4] = (counter0 + np.arange(rows)) & 0xFFFFFFFF
    for i in range(3):
        out[5 + i] = int.from_bytes(nonce[4 * i: 4 * i + 4], "little")
    out[8:24] = ct_rows.T if ct_rows.size else 0
    return out


def public_bit_matrix(pw: np.ndarray) -> np.ndarray:
    """[20, rows] words -> [768, rows] bit columns (32 bits LSB-first/word)."""
    rows = pw.shape[1]
    out = np.zeros((N_PUBLIC, rows), dtype=np.uint32)
    for wi in range(24):
        for i in range(32):
            out[32 * wi + i] = (pw[wi] >> i) & 1
    return out


def generate_trace(key: bytes, nonce: bytes, counter0: int,
                   pt_rows: np.ndarray, ct_rows: np.ndarray) -> np.ndarray:
    """pt_rows/ct_rows: uint32[rows, 16] LE words per block (already padded
    to the power-of-two row count, padding rows pt=keystream/ct=0).
    Returns the committed trace [n_committed, rows]."""
    rows = pt_rows.shape[0]
    key_words = [np.broadcast_to(
        np.uint32(int.from_bytes(key[4 * i: 4 * i + 4], "little")), (rows,))
        for i in range(8)]
    pw = public_words(nonce, counter0, ct_rows, rows)
    tw = TraceWalker(rows, pw)
    return _walk(tw, key_words=key_words, pt_words=list(pt_rows.T))

"""AES-CTR lookup AIR: trace layout, trace generation, constraint indices.

A copy of the JAX package's ``stark/aes_air.py`` (numpy on the host), with
P31 from the port's ``stark/m31.py``.

TPU-native re-design of stwo's AES-CTR production AIR with the LogUp S-box
table (reference behavior studied at stwo/src/aes/lookup/sbox_table.rs:35-120,
air_ctr.rs:118-236 and gen_ctr.rs; implemented fresh): one trace ROW = one
16-byte AES-CTR block (the row axis is the batch axis — the TPU analogue of
stwo's 16-lane u8x16 SIMD rows). Statement per row:

    AES_rk(nonce || BE32(counter0 + row)) XOR plaintext == ciphertext

with nonce/counter/ciphertext PUBLIC and round keys/plaintext private (round
keys are expanded host-side and committed once, shared by every row — the
same key-schedule scope as the reference, which splats host-expanded round
keys into the trace, gen_ctr.rs:353-384; here a row-constancy constraint
additionally pins every row to ONE schedule).

Column/constraint design (all degree <= 2):
  - bytes are 8 committed bit columns (LSB first), bool-constrained
  - AddRoundKey (rounds 0 and last): bitwise xor constraints
  - SubBytes: LogUp lookup against the 256-entry S-box table. The table is
    EMBEDDED IN THE TRACE (rows have a >= 256 floor, mirroring the
    reference's log_size >= 8 AES floor, wasm_api.rs:237): public columns
    give (tval, sval, tact) = (row, S(row), row < 256), a committed
    multiplicity column m counts lookups, and per-lookup interaction
    columns f hold 1/(z - (in + alpha*out)) with the pointwise constraint
    f * (z - (in + alpha*out)) = 1 (QM31, phase-2 commitment after z/alpha
    are drawn). A cumulative column cum satisfies
        cum(sigma x) - cum(x) - F(sigma x) = 0,  F = sum_j f_j - g
    on the WHOLE trace domain (sigma = one-row rotation of the circle
    domain); telescoping over the single sigma-cycle forces sum(F) = 0,
    i.e. the LogUp balance — no boundary selector or first-row machinery
    needed (the wrap-around IS the sum check).
  - MixColumns+AddRoundKey fused: each output bit r has integer-sum parity
    decomposition  sum(terms) = r + 2*(k0 + 2 k1 + 4 k2)  over <= 9 bit
    terms (the xtime/identity GF(2) expansion plus the round-key bit).
  - final XOR binding: ks + pt - 2 ks*pt - ct = 0 with ct a PUBLIC column
    (stronger binding than the reference's hash-mixed committed ciphertext,
    same rationale as chacha_air.py).

Value-matrix row order for constraint refs: [phase1 | phase2 | public | zero].
"""
from __future__ import annotations

import numpy as np

from .m31 import P31

# ---- AES tables (FIPS 197; values are public constants) ----

def _build_sbox():
    # multiplicative inverse via log/antilog over GF(2^8), then affine
    exp = [0] * 512
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= (x << 1) ^ (0x11B if x & 0x80 else 0)
        x &= 0xFF
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    sbox = [0] * 256
    for v in range(256):
        inv = 0 if v == 0 else exp[255 - log[v]]
        s = inv
        for _ in range(4):
            inv = ((inv << 1) | (inv >> 7)) & 0xFF
            s ^= inv
        sbox[v] = s ^ 0x63
    return np.asarray(sbox, dtype=np.uint8)


SBOX = _build_sbox()
RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]

# public column layout (per row):
#   ctr-block bits 16*8 | ciphertext bits 16*8 | tval | sval | tact
N_PUB = 16 * 8 + 16 * 8 + 3
PUB_TVAL = 256
PUB_SVAL = 257
PUB_TACT = 258


def _xt_terms(bits, i):
    """Bit-term list of xtime(a)_i given a's bit handles."""
    terms = [] if i == 0 else [bits[i - 1]]
    if (0x1B >> i) & 1:
        terms.append(bits[7])
    return terms


def expand_key(key: bytes):
    """FIPS 197 key expansion -> list of round keys (16 bytes each)."""
    nk = len(key) // 4
    nr = {4: 10, 8: 14}[nk]
    w = [list(key[4 * i: 4 * i + 4]) for i in range(nk)]
    for i in range(nk, 4 * (nr + 1)):
        t = list(w[i - 1])
        if i % nk == 0:
            t = t[1:] + t[:1]
            t = [SBOX[b] for b in t]
            t[0] ^= RCON[i // nk - 1]
        elif nk == 8 and i % nk == 4:
            t = [SBOX[b] for b in t]
        w.append([a ^ b for a, b in zip(w[i - nk], t)])
    return [bytes(sum((w[4 * r + c] for c in range(4)), []))
            for r in range(nr + 1)]


def _shiftrows_src(j: int) -> int:
    r, c = j % 4, j // 4
    return r + 4 * ((c + r) % 4)


class _Byte:
    __slots__ = ("bits", "value")

    def __init__(self, bits):
        self.bits = bits                  # 8 handles, LSB first


class IndexWalker:
    """Builds column counts + constraint index groups (no values)."""

    MIX_TMAX = 9                          # max parity terms (8 gf + 1 rk bit)

    def __init__(self):
        self.n1 = 0                       # phase-1 committed columns
        self.n_lk = 0                     # lookup instances
        self.bool_refs = []
        self.const_refs = []              # row-constant phase-1 columns
        self.xor = {k: [] for k in ("A", "B", "R")}
        self.mix = {"T": [], "R": [], "K0": [], "K1": [], "K2": []}
        self.lookup = {"U": [], "V": []}  # [n_lk, 8] bit refs each
        self.eq = {k: [] for k in ("KS", "PT", "CT")}

    ZERO = "Z"

    def _pub(self, idx: int):
        return ("p", idx)

    def _alloc_bit(self) -> int:
        r = self.n1
        self.n1 += 1
        self.bool_refs.append(r)
        return r

    def alloc_byte(self, *_ignored) -> _Byte:
        return _Byte([self._alloc_bit() for _ in range(8)])

    def const_byte(self, *_ignored) -> _Byte:
        b = self.alloc_byte()
        self.const_refs.extend(b.bits)
        return b

    def public_byte(self, byte_idx: int) -> _Byte:
        return _Byte([self._pub(8 * byte_idx + i) for i in range(8)])

    def xor_byte(self, a: _Byte, b: _Byte) -> _Byte:
        r = self.alloc_byte()
        for i in range(8):
            self.xor["A"].append(a.bits[i])
            self.xor["B"].append(b.bits[i])
            self.xor["R"].append(r.bits[i])
        return r

    def sbox(self, u: _Byte) -> _Byte:
        v = self.alloc_byte()
        self.lookup["U"].append(list(u.bits))
        self.lookup["V"].append(list(v.bits))
        self.n_lk += 1
        return v

    def sum_parity(self, terms) -> int:
        assert len(terms) <= self.MIX_TMAX
        r = self._alloc_bit()
        k0, k1, k2 = self._alloc_bit(), self._alloc_bit(), self._alloc_bit()
        self.mix["T"].append(list(terms) + [self.ZERO] * (self.MIX_TMAX
                                                          - len(terms)))
        self.mix["R"].append(r)
        self.mix["K0"].append(k0)
        self.mix["K1"].append(k1)
        self.mix["K2"].append(k2)
        return r

    def alloc_mult(self) -> int:
        r = self.n1                       # NOT bool-constrained
        self.n1 += 1
        return r

    def eq_bind(self, ks: _Byte, pt: _Byte, ct: _Byte):
        for i in range(8):
            self.eq["KS"].append(ks.bits[i])
            self.eq["PT"].append(pt.bits[i])
            self.eq["CT"].append(ct.bits[i])

    def finish(self, mult_ref: int):
        """Resolve refs into the value-matrix row space
        [phase1 | phase2 | public | zero]; phase-2 layout is
        [f_0..f_{n_lk-1} (4 each) | g (4) | cum (4)]."""
        n1 = self.n1
        n2 = 4 * (self.n_lk + 2)
        pub0 = n1 + n2
        zero = pub0 + N_PUB

        def fix(r):
            if r == self.ZERO:
                return zero
            if isinstance(r, tuple) and r[0] == "p":
                return pub0 + r[1]
            return r

        def fixarr(a):
            return np.asarray([[fix(r) for r in row] for row in a], np.int32) \
                if a and isinstance(a[0], list) else \
                np.asarray([fix(r) for r in a], np.int32)

        groups = {
            "bool": fixarr(self.bool_refs),
            "const": fixarr(self.const_refs),
            "xor": {k: fixarr(v) for k, v in self.xor.items()},
            "mix": {k: fixarr(v) for k, v in self.mix.items()},
            "lookup": {
                "U": fixarr(self.lookup["U"]),
                "V": fixarr(self.lookup["V"]),
                "F": np.asarray([[n1 + 4 * j + c for c in range(4)]
                                 for j in range(self.n_lk)], np.int32),
            },
            "table": {
                "M": np.int32(fix(mult_ref)),
                "G": np.asarray([n1 + 4 * self.n_lk + c
                                 for c in range(4)], np.int32),
                "TVAL": np.int32(pub0 + PUB_TVAL),
                "SVAL": np.int32(pub0 + PUB_SVAL),
                "TACT": np.int32(pub0 + PUB_TACT),
            },
            "cum": np.asarray([n1 + 4 * self.n_lk + 4 + c
                               for c in range(4)], np.int32),
            "eq": {k: fixarr(v) for k, v in self.eq.items()},
        }
        return n1, n2, groups


class TraceWalker:
    """Computes the phase-1 trace [n1, rows] plus per-lookup byte values.

    Allocation order must mirror IndexWalker exactly (the shared _walk function)."""

    MIX_TMAX = IndexWalker.MIX_TMAX
    ZERO = IndexWalker.ZERO

    def __init__(self, rows: int, pub_bytes: np.ndarray):
        self.rows = rows
        self.cols = []
        self.pub_bytes = pub_bytes        # uint8[32, rows]: ctr block | ct
        self.lk_u, self.lk_v = [], []

    def _push_byte(self, val: np.ndarray) -> _Byte:
        bits = []
        for i in range(8):
            arr = ((val >> i) & 1).astype(np.uint32)
            bits.append(arr)
            self.cols.append(arr)
        return _Byte(bits)

    def alloc_byte(self, val: np.ndarray) -> _Byte:
        b = self._push_byte(np.asarray(val))
        b.value = np.asarray(val)
        return b

    def const_byte(self, val) -> _Byte:
        return self.alloc_byte(np.broadcast_to(np.uint8(val), (self.rows,)))

    def public_byte(self, byte_idx: int) -> _Byte:
        val = self.pub_bytes[byte_idx]
        b = _Byte([((val >> i) & 1).astype(np.uint32) for i in range(8)])
        b.value = val
        return b

    def xor_byte(self, a: _Byte, b: _Byte) -> _Byte:
        return self.alloc_byte(a.value ^ b.value)

    def sbox(self, u: _Byte) -> _Byte:
        v = SBOX[u.value]
        self.lk_u.append(u.value.copy())
        self.lk_v.append(v.copy())
        return self.alloc_byte(v)

    def sum_parity(self, terms) -> np.ndarray:
        s = np.zeros(self.rows, dtype=np.uint32)
        for t in terms:
            s = s + t
        r = (s & 1).astype(np.uint32)
        k = s >> 1
        self.cols.append(r)
        for i in range(3):
            self.cols.append(((k >> i) & 1).astype(np.uint32))
        return r

    def alloc_mult(self, mult: np.ndarray):
        self.cols.append(mult.astype(np.uint32))

    def eq_bind(self, ks: _Byte, pt: _Byte, ct: _Byte):
        assert np.array_equal(ks.value ^ pt.value, ct.value), \
            "witness does not satisfy: keystream ^ plaintext != ciphertext"

    def finish(self):
        return (np.stack(self.cols),
                np.stack(self.lk_u).astype(np.uint32),
                np.stack(self.lk_v).astype(np.uint32))


def _mix_ark_all(b, sh, rk_round):
    """MixColumns fused with AddRoundKey: returns 16 new state bytes."""
    out = []
    for c in range(4):
        a = [sh[4 * c + r] for r in range(4)]
        k = [rk_round[4 * c + r] for r in range(4)]
        for r in range(4):
            a0, a1 = a[r], a[(r + 1) % 4]
            a2, a3 = a[(r + 2) % 4], a[(r + 3) % 4]
            bits = []
            for i in range(8):
                terms = _xt_terms(a0.bits, i) + _xt_terms(a1.bits, i)
                terms += [a1.bits[i], a2.bits[i], a3.bits[i], k[r].bits[i]]
                bits.append(b.sum_parity(terms))
            byte = _Byte(bits)
            if isinstance(b, TraceWalker):
                byte.value = np.zeros(b.rows, dtype=np.uint8)
                for i in range(8):
                    byte.value |= (bits[i].astype(np.uint8) << i)
            out.append(byte)
    return out


def _walk(b, key_size: int, rk_bytes=None, pt_rows=None, mult=None):
    """Shared circuit walk; rk_bytes/pt_rows/mult only used by TraceWalker."""
    is_trace = isinstance(b, TraceWalker)
    nr = {16: 10, 32: 14}[key_size]
    rk = [[b.const_byte(rk_bytes[r][j] if is_trace else None)
           for j in range(16)] for r in range(nr + 1)]
    ctr = [b.public_byte(j) for j in range(16)]
    st = [b.xor_byte(ctr[j], rk[0][j]) for j in range(16)]
    for rnd in range(1, nr):
        sb = [b.sbox(st[j]) for j in range(16)]
        sh = [sb[_shiftrows_src(j)] for j in range(16)]
        st = _mix_ark_all(b, sh, rk[rnd])
    sb = [b.sbox(st[j]) for j in range(16)]
    sh = [sb[_shiftrows_src(j)] for j in range(16)]
    ks = [b.xor_byte(sh[j], rk[nr][j]) for j in range(16)]
    pt = [b.alloc_byte(pt_rows[j] if is_trace else None) for j in range(16)]
    for j in range(16):
        b.eq_bind(ks[j], pt[j], b.public_byte(16 + j))
    if is_trace:
        b.alloc_mult(mult)
        return b.finish()
    return b.finish(b.alloc_mult())


_LAYOUT_CACHE = {}


def layout(key_size: int):
    """(n1, n2, groups) for the AES-CTR AIR (cached per key size)."""
    if key_size not in _LAYOUT_CACHE:
        _LAYOUT_CACHE[key_size] = _walk(IndexWalker(), key_size)
    return _LAYOUT_CACHE[key_size]


def counter_blocks(nonce: bytes, counter0: int, rows: int) -> np.ndarray:
    """uint8[16, rows]: nonce || BE32(counter0 + row) per row."""
    out = np.zeros((16, rows), dtype=np.uint8)
    for i in range(12):
        out[i] = nonce[i]
    ctr = (counter0 + np.arange(rows)) & 0xFFFFFFFF
    for i in range(4):
        out[12 + i] = (ctr >> (8 * (3 - i))) & 0xFF
    return out


def public_bytes(nonce: bytes, counter0: int, ct_rows: np.ndarray,
                 rows: int) -> np.ndarray:
    """uint8[32, rows]: counter block bytes | ciphertext bytes."""
    return np.concatenate([counter_blocks(nonce, counter0, rows),
                           ct_rows.T.astype(np.uint8)])


def public_matrix(pub_bytes: np.ndarray) -> np.ndarray:
    """uint8[32, rows] -> uint32[N_PUB, rows] value columns
    (bits | tval | sval | tact)."""
    rows = pub_bytes.shape[1]
    out = np.zeros((N_PUB, rows), dtype=np.uint32)
    for bidx in range(32):
        for i in range(8):
            out[8 * bidx + i] = (pub_bytes[bidx] >> i) & 1
    r = np.arange(rows)
    tval = np.where(r < 256, r, 0).astype(np.uint32)
    out[PUB_TVAL] = tval
    out[PUB_SVAL] = SBOX[tval].astype(np.uint32)
    out[PUB_TACT] = (r < 256).astype(np.uint32)
    return out


def generate_trace(key: bytes, nonce: bytes, counter0: int,
                   pt_rows: np.ndarray, ct_rows: np.ndarray):
    """pt_rows/ct_rows: uint8[rows, 16] per-block bytes (already padded:
    padding rows pt=keystream, ct=0). Returns (trace1 [n1, rows] uint32,
    lk_u [n_lk, rows], lk_v [n_lk, rows])."""
    rows = pt_rows.shape[0]
    rk = expand_key(key)
    pb = public_bytes(nonce, counter0, ct_rows, rows)
    # multiplicity: lookups-per-byte-value over the whole trace
    tw = TraceWalker(rows, pb)
    trace1, lk_u, lk_v = _walk(
        tw, len(key), rk_bytes=rk,
        pt_rows=[pt_rows[:, j].astype(np.uint8) for j in range(16)],
        mult=np.zeros(rows, dtype=np.uint32))
    counts = np.bincount(lk_u.reshape(-1), minlength=256)[:256]
    mult = np.zeros(rows, dtype=np.uint32)
    mult[:256] = counts
    trace1[-1] = mult                     # overwrite the placeholder
    return trace1, lk_u, lk_v


def sigma_perm(m: int, s: int) -> np.ndarray:
    """Index permutation of the size-m standard circle coset under rotation
    by the size-(m/s) subgroup generator: perm[i] = index of sigma(p_i).
    (Ordering per stark.circle: first half ascending odd powers, second half
    their conjugates.)"""
    i = np.arange(m)
    half = m // 2
    first = i < half
    t = i + s
    wrapped = (3 * half) - 1 - t          # 3m/2 - 1 - (i+s)
    fh = np.where(t < half, t, wrapped)
    j = i - half
    sh = np.where(j >= s, i - s, s - j - 1)
    return np.where(first, fh, sh).astype(np.int32)


def cum_column(F_qm, rows: int):
    """F_qm: uint32[4, rows] net fraction per row. Returns cum uint32[4, rows]
    with cum[sigma(r)] = cum[r] + F[sigma(r)] along the sigma cycle."""
    perm = sigma_perm(rows, 1)
    cum = np.zeros((4, rows), dtype=np.uint64)
    cur = 0
    acc = np.zeros(4, dtype=np.uint64)
    for _ in range(rows - 1):
        nxt = int(perm[cur])
        acc = (acc + F_qm[:, nxt].astype(np.uint64)) % P31
        cum[:, nxt] = acc
        cur = nxt
    return cum.astype(np.uint32)

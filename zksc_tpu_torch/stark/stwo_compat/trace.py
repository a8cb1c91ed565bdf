"""ChaCha20 stream trace (stwo-compatible), built for all blocks at once.

Trace: one row per ChaCha block; 33280 M31 bit columns in the exact
read-order of the AIR evaluator (air.py). Rows are stored in natural block
order; stwo treats stored order as bit-reversed domain order, so stored
row r is the evaluation at trace_domain.at(bit_reverse(r)).

``stream_trace`` walks the block function as int64 word operations over the
block axis on the inputs' device (the reference's ``generate_stream_trace``
walks one row at a time in Python): every u32 the walk pushes gives 32 bit
columns, an add its result and then its 32 carries. The result is the
[columns, rows] layout the circle FFT (K7b) takes.

``generate_trace_row`` and ``basis_eval_qm31`` are copied from the JAX
package's ``stark/stwo_compat/trace.py``: the row oracle, and the basis at
the OODS point (the prover's samples). The reference's dense
``LdeContext`` is left out: ``cfft`` replaces it.
"""
from __future__ import annotations

import torch

from . import field as F

MASK32 = 0xFFFFFFFF
N_COLS = 33280
CHACHA_CONSTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_QR_IDX = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
           (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def generate_trace_row(key_words, nonce_words, counter):
    """One block's 33280 column values (python ints 0/1... and carries).
    Returns (cols, keystream_words)."""
    cols = []

    def push_u32(x):
        for i in range(32):
            cols.append((x >> i) & 1)

    def add32(a, b):
        s = a + b
        res = s & MASK32
        push_u32(res)
        # carries: carry[i] = carry out of bit i
        c = 0
        for i in range(32):
            c = ((a >> i & 1) + (b >> i & 1) + c) >> 1
            cols.append(c)
        return res

    def xor_rotl(a, b, r):
        res = _rotl(a ^ b, r)
        push_u32(res)
        return res

    state = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
             *key_words, counter & MASK32, *nonce_words]
    for w in state:
        push_u32(w)
    v = list(state)

    def qr(a, b, c, d):
        v[a] = add32(v[a], v[b])
        v[d] = xor_rotl(v[a], v[d], 16)
        v[c] = add32(v[c], v[d])
        v[b] = xor_rotl(v[c], v[b], 12)
        v[a] = add32(v[a], v[b])
        v[d] = xor_rotl(v[a], v[d], 8)
        v[c] = add32(v[c], v[d])
        v[b] = xor_rotl(v[c], v[b], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)

    keystream = [add32(v[i], state[i]) for i in range(16)]
    return cols, keystream


def stream_trace(key_words, nonce_words, counters: torch.Tensor,
                 pt_words: torch.Tensor, ct_words: torch.Tensor,
                 n_real: int | None = None):
    """The trace of n blocks: key_words (8) and nonce_words (3) as ints,
    counters int64 [n] (already wrapped mod 2^32), pt_words and ct_words
    int64 [n, 16] LE words, all on one device. Rows from n_real on (default
    n) are padding: plaintext 0 and, in place of ct_words, their own
    keystream (the reference's prover.py:83-89). Returns (trace int32
    [33280, n] on that device, valid): valid is False unless every block's
    keystream xor plaintext equals its ciphertext (the reference's
    trace.py:100-102)."""
    n = counters.shape[0]
    dev = counters.device
    words = []                        # each pushed u32 word: int64 [n]

    def const(w):
        return torch.full((n,), w, dtype=torch.int64, device=dev)

    def add32(a, b):
        s = a + b
        words.append(s & MASK32)
        words.append((s ^ a ^ b) >> 1)    # bit i: the carry out of bit i
        return s & MASK32

    def xor_rotl(a, b, r):
        res = _rotl(a ^ b, r)
        words.append(res)
        return res

    state = ([const(w) for w in CHACHA_CONSTS] + [const(w) for w in key_words]
             + [counters.to(torch.int64) & MASK32]
             + [const(w) for w in nonce_words])
    words += state
    v = list(state)
    for _ in range(10):
        for a, b, c, d in _QR_IDX:
            v[a] = add32(v[a], v[b])
            v[d] = xor_rotl(v[a], v[d], 16)
            v[c] = add32(v[c], v[d])
            v[b] = xor_rotl(v[c], v[b], 12)
            v[a] = add32(v[a], v[b])
            v[d] = xor_rotl(v[a], v[d], 8)
            v[c] = add32(v[c], v[d])
            v[b] = xor_rotl(v[c], v[b], 7)
    ks = torch.stack([add32(v[i], state[i]) for i in range(16)], dim=1)
    if n_real is not None and n_real < n:
        ct_words = torch.cat([ct_words[:n_real], ks[n_real:]])
    words += list(pt_words.T) + list(ct_words.T)
    valid = bool(torch.equal(ks ^ pt_words, ct_words))
    shifts = torch.arange(32, device=dev)[None, :, None]
    bits = (torch.stack(words)[:, None, :] >> shifts) & 1      # [words, 32, n]
    trace = bits.reshape(-1, n).to(torch.int32)
    assert trace.shape[0] == N_COLS, trace.shape
    return trace, valid


def basis_eval_qm31(point, log_size: int):
    """Basis values at a QM31 point (for OODS sampling)."""
    x, y = point
    pis = [x]
    for _ in range(log_size - 2):
        p2 = F.mul(pis[-1], pis[-1])
        pis.append(F.sub(F.add(p2, p2), F.ONE))
    out = []
    for j in range(1 << log_size):
        v = y if (j & 1) else F.ONE
        for k in range(log_size - 1):
            if (j >> (1 + k)) & 1:
                v = F.mul(v, pis[k])
        out.append(v)
    return out

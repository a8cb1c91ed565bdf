"""ChaCha20 on the host (numpy), for the API's local decrypt.

Only the numpy twin of the JAX package's ``ops/ciphers.py`` (RFC 7539
block function and CTR encrypt) is ported in this slice: the prover needs
the plaintext of one 128-byte chunk, which is tiny host work.
"""
from __future__ import annotations

import numpy as np

CHACHA_CONSTS = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574],
                         dtype=np.uint32)

_QR_COLS = [(0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15)]
_QR_DIAG = [(0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14)]


def _chacha20_block_np(key_words: np.ndarray, nonce_words: np.ndarray,
                       counters: np.ndarray) -> np.ndarray:
    """ChaCha20 block function: key uint32[B, 8], nonce uint32[B, 3],
    counters uint32[B] -> keystream words uint32[B, 16]."""
    B = key_words.shape[0]
    state0 = np.concatenate([
        np.broadcast_to(CHACHA_CONSTS, (B, 4)), key_words,
        counters[:, None].astype(np.uint32), nonce_words], axis=1)
    xs = [state0[:, i].copy() for i in range(16)]

    def rotl(x, n):
        return ((x << np.uint32(n)) | (x >> np.uint32(32 - n))).astype(np.uint32)

    with np.errstate(over="ignore"):
        for _ in range(10):
            for pattern in (_QR_COLS, _QR_DIAG):
                for (ia, ib, ic, id_) in pattern:
                    a, b, c, d = xs[ia], xs[ib], xs[ic], xs[id_]
                    a = a + b; d = rotl(d ^ a, 16)
                    c = c + d; b = rotl(b ^ c, 12)
                    a = a + b; d = rotl(d ^ a, 8)
                    c = c + d; b = rotl(b ^ c, 7)
                    xs[ia], xs[ib], xs[ic], xs[id_] = a, b, c, d
        out = [(x + state0[:, i]).astype(np.uint32) for i, x in enumerate(xs)]
    return np.stack(out, axis=1)


def chacha20_encrypt(key: bytes, nonce: bytes, counter: int, data: bytes) -> bytes:
    """Host-convenience CTR encrypt/decrypt of arbitrary-length data
    (per-block counters counter, counter+1, ...). Pure numpy."""
    n_blocks = (len(data) + 63) // 64
    if n_blocks == 0:
        return b""
    kw = np.frombuffer(key, np.uint8).reshape(8, 4)
    kw = (kw[:, 0].astype(np.uint32) | (kw[:, 1].astype(np.uint32) << 8)
          | (kw[:, 2].astype(np.uint32) << 16) | (kw[:, 3].astype(np.uint32) << 24))
    nw = np.frombuffer(nonce, np.uint8).reshape(3, 4)
    nw = (nw[:, 0].astype(np.uint32) | (nw[:, 1].astype(np.uint32) << 8)
          | (nw[:, 2].astype(np.uint32) << 16) | (nw[:, 3].astype(np.uint32) << 24))
    ctrs = np.arange(counter, counter + n_blocks, dtype=np.uint32)
    ks_words = _chacha20_block_np(np.broadcast_to(kw, (n_blocks, 8)),
                                  np.broadcast_to(nw, (n_blocks, 3)), ctrs)
    ks = np.stack([(ks_words >> (8 * i)) & 0xFF for i in range(4)],
                  axis=-1).astype(np.uint8).reshape(-1)[: len(data)]
    return (np.frombuffer(data, np.uint8) ^ ks).tobytes()

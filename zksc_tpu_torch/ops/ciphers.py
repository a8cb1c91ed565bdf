"""ChaCha20 and AES-128/256-CTR: numpy on the host for the API's local
decrypt and the AES circuit's tables, and both ciphers as torch ops over a
block axis.

The numpy twins of the JAX package's ``ops/ciphers.py`` (RFC 7539 ChaCha20,
FIPS 197 AES with its S-box, round constants, GF(2^8) inverse table and key
schedule, CTR mode: IV = 12-byte nonce || 4-byte big-endian counter). The
prover needs the plaintext of one chunk (128 or 80 bytes), which is tiny
host work. ``chacha20_block_words`` / ``chacha20_keystream`` and
``aes_encrypt_blocks`` / ``aes_ctr_counter_blocks`` / ``aes_ctr_keystream``
are the reference's batched ciphers (ops/ciphers.py:55, :98, :239, :277,
:285) on tensors of any device: the tensors' own.
"""
from __future__ import annotations

import numpy as np
import torch

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


MASK32 = 0xFFFFFFFF


def _rotl_t(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) | (x >> (32 - n))) & MASK32


def chacha20_block_words(key_words: torch.Tensor, nonce_words: torch.Tensor,
                         counter: torch.Tensor) -> torch.Tensor:
    """One ChaCha20 block per batch lane, as torch ops on the inputs'
    device: key_words [B, 8] (LE words), nonce_words [B, 3], counter [B],
    integer tensors holding u32 values. Returns the keystream words as int64
    [B, 16] in [0, 2^32)."""
    B = key_words.shape[0]
    dev = key_words.device
    consts = torch.as_tensor(CHACHA_CONSTS.astype(np.int64), device=dev)
    state0 = torch.cat([consts.expand(B, 4), key_words.to(torch.int64),
                        counter.to(torch.int64)[:, None],
                        nonce_words.to(torch.int64)], dim=1) & MASK32
    xs = list(state0.unbind(1))
    for _ in range(10):
        for pattern in (_QR_COLS, _QR_DIAG):
            for (ia, ib, ic, id_) in pattern:
                a, b, c, d = xs[ia], xs[ib], xs[ic], xs[id_]
                a = (a + b) & MASK32; d = _rotl_t(d ^ a, 16)
                c = (c + d) & MASK32; b = _rotl_t(b ^ c, 12)
                a = (a + b) & MASK32; d = _rotl_t(d ^ a, 8)
                c = (c + d) & MASK32; b = _rotl_t(b ^ c, 7)
                xs[ia], xs[ib], xs[ic], xs[id_] = a, b, c, d
    return (torch.stack(xs, dim=1) + state0) & MASK32


def chacha20_keystream(key_bytes: torch.Tensor, nonce_bytes: torch.Tensor,
                       counters: torch.Tensor) -> torch.Tensor:
    """Batched keystream: key uint8 [B, 32], nonce uint8 [B, 12], counters
    [B] -> keystream bytes uint8 [B, 64]."""
    def words(b):
        b = b.to(torch.int64).reshape(b.shape[0], -1, 4)
        return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    ks = chacha20_block_words(words(key_bytes), words(nonce_bytes), counters)
    return torch.stack([(ks >> (8 * i)) & 0xFF for i in range(4)],
                       dim=-1).reshape(ks.shape[0], 64).to(torch.uint8)


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


# ---------------------------------------------------------------------------
# AES-128 / AES-256 (CTR mode)
# ---------------------------------------------------------------------------

def _build_aes_sbox() -> np.ndarray:
    """Compute the AES S-box from GF(2^8) inversion + affine map (FIPS 197)."""
    # multiplicative inverse table via exp/log over generator 3
    exp = np.zeros(512, dtype=np.uint16)
    log = np.zeros(256, dtype=np.uint16)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        # multiply by generator 0x03 = x * 2 ^ x
        x2 = ((x << 1) ^ (0x11B if x & 0x80 else 0)) & 0xFF
        x = x2 ^ x
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    inv = np.zeros(256, dtype=np.uint8)
    for a in range(1, 256):
        inv[a] = exp[255 - log[a]]
    sbox = np.zeros(256, dtype=np.uint8)
    for a in range(256):
        b = int(inv[a])
        s = 0x63
        for i in range(8):
            bit = ((b >> i) & 1) ^ ((b >> ((i + 4) % 8)) & 1) ^ \
                  ((b >> ((i + 5) % 8)) & 1) ^ ((b >> ((i + 6) % 8)) & 1) ^ \
                  ((b >> ((i + 7) % 8)) & 1)
            s ^= bit << i
        sbox[a] = s
    return sbox


AES_SBOX = _build_aes_sbox()
AES_INV_SBOX = np.zeros(256, dtype=np.uint8)
AES_INV_SBOX[AES_SBOX] = np.arange(256, dtype=np.uint8)
AES_RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36],
                    dtype=np.uint8)
# GF(2^8) multiplicative inverse table (0 -> 0), used by the AES R1CS circuit's
# S-box hint (sound inverse-based S-box instead of the reference circom's
# unconstrained T-table lookups — see SURVEY.md §2.2).
_e = np.zeros(256, dtype=np.uint8)
for _a in range(1, 256):
    for _b in range(1, 256):
        _p, _x, _y = 0, _a, _b
        # carryless multiply then reduce — small one-time host loop
        while _y:
            if _y & 1:
                _p ^= _x
            _y >>= 1
            _x <<= 1
            if _x & 0x100:
                _x ^= 0x11B
        if _p == 1:
            _e[_a] = _b
            break
AES_GF_INV = _e


def aes_expand_key(key: np.ndarray) -> np.ndarray:
    """Host key expansion: key uint8[16 or 32] -> round keys uint8[R+1, 16]
    (R=10 for AES-128, 14 for AES-256)."""
    key = np.asarray(key, dtype=np.uint8)
    nk = len(key) // 4
    rounds = {4: 10, 8: 14}[nk]
    words = [key[4 * i: 4 * i + 4].copy() for i in range(nk)]
    for i in range(nk, 4 * (rounds + 1)):
        temp = words[i - 1].copy()
        if i % nk == 0:
            temp = np.roll(temp, -1)
            temp = AES_SBOX[temp]
            temp[0] ^= AES_RCON[i // nk - 1]
        elif nk > 6 and i % nk == 4:
            temp = AES_SBOX[temp]
        words.append(words[i - nk] ^ temp)
    return np.stack(words).reshape(rounds + 1, 16)


_SHIFT_ROWS = [0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11]


def _xtime_t(x: torch.Tensor) -> torch.Tensor:
    """GF(2^8) multiply by 2 of byte values held in an integer tensor."""
    return ((x << 1) ^ torch.where((x & 0x80) != 0, 0x1B, 0)) & 0xFF


def aes_encrypt_blocks(blocks: torch.Tensor, round_keys) -> torch.Tensor:
    """Batched AES block encryption on the blocks' device.

    blocks: uint8 [B, 16] (column-major AES state = standard byte order);
    round_keys: uint8 [R+1, 16] or [B, R+1, 16] (per-lane keys), a tensor or
    a numpy array (``aes_expand_key``'s output). Returns uint8 [B, 16]."""
    dev = blocks.device
    sbox = torch.as_tensor(AES_SBOX.astype(np.int64), device=dev)
    shift = torch.tensor(_SHIFT_ROWS, device=dev)
    st = blocks.to(torch.int64)
    rk = torch.as_tensor(round_keys, device=dev).to(torch.int64)
    if rk.dim() == 2:
        rk = rk.unsqueeze(0)
    n_rounds = rk.shape[1] - 1
    st = st ^ rk[:, 0]
    for r in range(1, n_rounds + 1):
        st = sbox.index_select(0, st.reshape(-1)).reshape(st.shape)  # SubBytes
        st = st.index_select(1, shift)                               # ShiftRows
        if r != n_rounds:                                            # MixColumns
            cols = st.reshape(-1, 4, 4)
            a0, a1, a2, a3 = cols.unbind(2)
            x0, x1, x2, x3 = (_xtime_t(a) for a in (a0, a1, a2, a3))
            st = torch.stack([x0 ^ x1 ^ a1 ^ a2 ^ a3,
                              a0 ^ x1 ^ x2 ^ a2 ^ a3,
                              a0 ^ a1 ^ x2 ^ x3 ^ a3,
                              x0 ^ a0 ^ a1 ^ a2 ^ x3], dim=2).reshape(-1, 16)
        st = st ^ rk[:, r]
    return st.to(torch.uint8)


def aes_ctr_counter_blocks(nonce_bytes: torch.Tensor,
                           counters: torch.Tensor) -> torch.Tensor:
    """IV blocks: nonce uint8 [B, 12] || BE32(counter) -> uint8 [B, 16]."""
    c = counters.to(torch.int64)
    ctr_be = torch.stack([(c >> 24) & 0xFF, (c >> 16) & 0xFF,
                          (c >> 8) & 0xFF, c & 0xFF], dim=1)
    return torch.cat([nonce_bytes.to(torch.uint8), ctr_be.to(torch.uint8)],
                     dim=1)


def aes_ctr_keystream(key: bytes, nonce_bytes: torch.Tensor,
                      counters: torch.Tensor) -> torch.Tensor:
    """Batched AES-CTR keystream blocks for one key, on the nonces' device:
    uint8 [B, 16]."""
    rks = aes_expand_key(np.frombuffer(key, np.uint8))
    return aes_encrypt_blocks(aes_ctr_counter_blocks(nonce_bytes, counters),
                              rks)


def _aes_encrypt_blocks_np(blocks: np.ndarray, round_keys: np.ndarray) -> np.ndarray:
    """Pure-numpy twin of aes_encrypt_blocks for host-side use."""
    shift_idx = np.array([0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11])
    st = blocks.astype(np.uint32)
    rk = round_keys.astype(np.uint32)
    n_rounds = rk.shape[0] - 1
    st = st ^ rk[0]

    def xt(x):
        return ((x << 1) ^ np.where((x & 0x80) != 0, 0x1B, 0)) & 0xFF

    for r in range(1, n_rounds + 1):
        st = AES_SBOX[st].astype(np.uint32)
        st = st[:, shift_idx]
        if r != n_rounds:
            cols = st.reshape(-1, 4, 4)
            a0, a1, a2, a3 = cols[:, :, 0], cols[:, :, 1], cols[:, :, 2], cols[:, :, 3]
            r0 = xt(a0) ^ (xt(a1) ^ a1) ^ a2 ^ a3
            r1 = a0 ^ xt(a1) ^ (xt(a2) ^ a2) ^ a3
            r2 = a0 ^ a1 ^ xt(a2) ^ (xt(a3) ^ a3)
            r3 = (xt(a0) ^ a0) ^ a1 ^ a2 ^ xt(a3)
            st = np.stack([r0, r1, r2, r3], axis=2).reshape(-1, 16)
        st = st ^ rk[r]
    return st.astype(np.uint8)


def aes_ctr_encrypt(key: bytes, nonce: bytes, counter: int, data: bytes) -> bytes:
    """Host-convenience AES-CTR over arbitrary-length data. Pure numpy."""
    n_blocks = (len(data) + 15) // 16
    if n_blocks == 0:
        return b""
    rks = aes_expand_key(np.frombuffer(key, np.uint8))
    ctrs = np.arange(counter, counter + n_blocks, dtype=np.uint32)
    ivs = np.concatenate([
        np.broadcast_to(np.frombuffer(nonce, np.uint8), (n_blocks, 12)),
        np.stack([(ctrs >> 24) & 0xFF, (ctrs >> 16) & 0xFF,
                  (ctrs >> 8) & 0xFF, ctrs & 0xFF], axis=1).astype(np.uint8),
    ], axis=1)
    ks = _aes_encrypt_blocks_np(ivs, rks).reshape(-1)[: len(data)]
    return (np.frombuffer(data, np.uint8) ^ ks).tobytes()

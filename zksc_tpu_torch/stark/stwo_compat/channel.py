"""Bit-exact replica of stwo's Blake2s Fiat-Shamir channel (stwo @ f117d48).

Copied from the JAX package's ``stark/stwo_compat/channel.py``.

Semantics established empirically by tracing the reference module's blake2s
compression calls during `verify_chacha20_proof` (see NOTES.md):

  initial digest   = 32 zero bytes
  mix_root(r)      : digest = blake2s(digest || r)                (64 B)
  mix_u64(v)       : digest = blake2s(digest || v as 8 B LE)      (40 B)
  mix_felts(felts) : digest = blake2s(digest || concat(qm31 as 4xu32 LE))
  draw_random_bytes: out = blake2s(digest || n_sent as 4 B LE || 0x00)
                     n_sent += 1 (resets to 0 on every digest update)
  proof of work    : seed  = blake2s(magic(0x12345678 LE, padded to 16 B)
                                     || digest || pow_bits as 4 B LE)
                     check = blake2s(seed || nonce as 8 B LE)
                     trailing_zeros(u128::from_le(check[0:16])) >= pow_bits
                     then channel.mix_u64(nonce)

Field-element draws (draw_felt / draw_base_felts): one draw_random_bytes
gives 8 u32 words (LE); retry the whole draw while any word >= 2*(2^31-1);
reduce each mod P. draw_felt = first 4 words as QM31 coordinates.
"""
from __future__ import annotations

import hashlib
import struct

P = (1 << 31) - 1


def _b2s(data: bytes) -> bytes:
    return hashlib.blake2s(data).digest()


def qm31_bytes(q) -> bytes:
    return struct.pack("<4I", *[int(x) & 0xFFFFFFFF for x in q])


class Blake2sChannel:
    def __init__(self):
        self.digest = b"\x00" * 32
        self.n_sent = 0

    def _update(self, new_digest: bytes):
        self.digest = new_digest
        self.n_sent = 0

    def mix_root(self, root: bytes):
        self._update(_b2s(self.digest + root))

    def mix_u64(self, v: int):
        self._update(_b2s(self.digest + struct.pack("<Q", v & (2**64 - 1))))

    def mix_felts(self, felts):
        self._update(_b2s(self.digest
                          + b"".join(qm31_bytes(q) for q in felts)))

    def draw_random_bytes(self) -> bytes:
        out = _b2s(self.digest + struct.pack("<I", self.n_sent) + b"\x00")
        self.n_sent += 1
        return out

    def draw_base_felts(self):
        """8 M31 felts per draw; reject-and-retry while any u32 >= 2P."""
        while True:
            words = struct.unpack("<8I", self.draw_random_bytes())
            if all(w < 2 * P for w in words):
                return [w % P for w in words]

    def draw_felt(self):
        """One QM31 as (a0, a1, b0, b1)."""
        return tuple(self.draw_base_felts()[:4])

    def draw_felts(self, n: int):
        out = []
        while len(out) < n:
            f = self.draw_base_felts()
            out.append(tuple(f[:4]))
            if len(out) < n:
                out.append(tuple(f[4:]))
        return out[:n]

    # ---- proof of work (grind) ----

    POW_MAGIC = struct.pack("<I", 0x12345678) + b"\x00" * 12

    def pow_seed(self, pow_bits: int) -> bytes:
        return _b2s(self.POW_MAGIC + self.digest
                    + struct.pack("<I", pow_bits))

    @staticmethod
    def pow_trailing_zeros(seed: bytes, nonce: int) -> int:
        chk = _b2s(seed + struct.pack("<Q", nonce))
        v = int.from_bytes(chk[:16], "little")
        return 128 if v == 0 else (v & -v).bit_length() - 1

    def check_pow(self, pow_bits: int, nonce: int) -> bool:
        ok = self.pow_trailing_zeros(self.pow_seed(pow_bits),
                                     nonce) >= pow_bits
        self.mix_u64(nonce)
        return ok

    def grind(self, pow_bits: int) -> int:
        seed = self.pow_seed(pow_bits)
        nonce = 0
        while self.pow_trailing_zeros(seed, nonce) < pow_bits:
            nonce += 1
        self.mix_u64(nonce)
        return nonce

"""Blake2s Fiat-Shamir channel for the Circle-STARK engine.

A copy of the JAX package's ``stark/channel.py`` (host code, hashlib).

Host-side (the transcript is tiny and inherently sequential). Fills the role
of stwo's Blake2sChannel: absorb commitments/public inputs, squeeze field
challenges, query indices, and check proof-of-work grinding
(reference behavior: stwo air_stream.rs channel replay order — studied;
transcript layout here is our own, documented format).
"""
from __future__ import annotations

import hashlib

from .m31 import P31


class Channel:
    def __init__(self, seed: bytes = b"zksc-tpu-stark-v1"):
        self.digest = hashlib.blake2s(seed, digest_size=32).digest()
        self.counter = 0

    def _absorb(self, data: bytes):
        self.digest = hashlib.blake2s(self.digest + data,
                                      digest_size=32).digest()
        self.counter = 0

    def mix_bytes(self, data: bytes):
        self._absorb(b"B" + len(data).to_bytes(8, "little") + data)

    def mix_felts(self, felts):
        """Absorb a list of M31 values."""
        buf = b"".join(int(f).to_bytes(4, "little") for f in felts)
        self._absorb(b"F" + len(buf).to_bytes(8, "little") + buf)

    def mix_u64(self, v: int):
        self._absorb(b"U" + int(v).to_bytes(8, "little"))

    def _squeeze(self) -> bytes:
        out = hashlib.blake2s(
            self.digest + self.counter.to_bytes(8, "little"),
            digest_size=32).digest()
        self.counter += 1
        return out

    def draw_m31(self) -> int:
        """Uniform M31 element (rejection sampling on 31-bit windows)."""
        while True:
            raw = self._squeeze()
            for i in range(0, 32, 4):
                v = int.from_bytes(raw[i:i + 4], "little") & 0x7FFFFFFF
                if v != P31:
                    return v

    def draw_qm31(self):
        return ((self.draw_m31(), self.draw_m31()),
                (self.draw_m31(), self.draw_m31()))

    def draw_queries(self, n_queries: int, domain_log_size: int) -> list:
        """Distinct query indices in [0, 2^domain_log_size)."""
        mask = (1 << domain_log_size) - 1
        out = []
        seen = set()
        while len(out) < n_queries:
            raw = self._squeeze()
            for i in range(0, 32, 4):
                idx = int.from_bytes(raw[i:i + 4], "little") & mask
                if idx not in seen:
                    seen.add(idx)
                    out.append(idx)
                    if len(out) == n_queries:
                        break
        return out

    def check_pow(self, nonce: int, bits: int) -> bool:
        h = hashlib.blake2s(self.digest + int(nonce).to_bytes(8, "little"),
                            digest_size=32).digest()
        v = int.from_bytes(h[:8], "little")
        return v < (1 << (64 - bits))

    def grind_pow(self, bits: int, max_iters: int = 1 << 28) -> int:
        for nonce in range(max_iters):
            if self.check_pow(nonce, bits):
                self.mix_u64(nonce)
                return nonce
        raise RuntimeError("pow grinding failed")

    def mix_pow_nonce(self, nonce: int):
        self.mix_u64(nonce)

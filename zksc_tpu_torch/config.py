"""Per-algorithm constant registry.

Mirrors the reference's CONFIG (js/src/config.ts:8-59 — semantics studied,
re-expressed): chunk sizes, key/iv sizes, start counters, blocks per chunk.

A proof always covers exactly one fixed-size chunk:
  chacha20: 2 x 64 B blocks = 128 B, startCounter 1 (TLS inner counter)
  aes-128-ctr / aes-256-ctr: 5 x 16 B blocks = 80 B, startCounter 2
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AlgorithmConfig:
    name: str
    key_size_bytes: int
    iv_size_bytes: int
    block_size_bytes: int
    blocks_per_chunk: int
    start_counter: int

    @property
    def chunk_size_bytes(self) -> int:
        return self.block_size_bytes * self.blocks_per_chunk


CONFIG = {
    "chacha20": AlgorithmConfig(
        name="chacha20", key_size_bytes=32, iv_size_bytes=12,
        block_size_bytes=64, blocks_per_chunk=2, start_counter=1),
    "aes-128-ctr": AlgorithmConfig(
        name="aes-128-ctr", key_size_bytes=16, iv_size_bytes=12,
        block_size_bytes=16, blocks_per_chunk=5, start_counter=2),
    "aes-256-ctr": AlgorithmConfig(
        name="aes-256-ctr", key_size_bytes=32, iv_size_bytes=12,
        block_size_bytes=16, blocks_per_chunk=5, start_counter=2),
}

# TOPRF variants share the base cipher geometry; the circuit statement adds
# the TOPRF verification layer (reference: gnark/circuits/{chachaV3_oprf,
# aesV2_oprf} reuse the base circuit constants).
for _base in ("chacha20", "aes-128-ctr", "aes-256-ctr"):
    _c = CONFIG[_base]
    CONFIG[f"{_base}-toprf"] = AlgorithmConfig(
        name=f"{_base}-toprf", key_size_bytes=_c.key_size_bytes,
        iv_size_bytes=_c.iv_size_bytes, block_size_bytes=_c.block_size_bytes,
        blocks_per_chunk=_c.blocks_per_chunk, start_counter=_c.start_counter)

SUPPORTED_ALGORITHMS = tuple(CONFIG)


def get_counter_for_byte_offset(algorithm: str, offset_bytes: int) -> int:
    """Counter for a chunk starting at byte offset (must be block-aligned).
    Mirrors js/src/utils.ts:206-220 behavior."""
    cfg = CONFIG[algorithm]
    if offset_bytes % cfg.block_size_bytes != 0:
        raise ValueError(
            f"offset {offset_bytes} not a multiple of block size "
            f"{cfg.block_size_bytes}")
    return cfg.start_counter + offset_bytes // cfg.block_size_bytes

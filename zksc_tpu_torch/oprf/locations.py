"""Logical-location -> physical-bitmask mapping for TOPRF circuits.

Behavior parity with the reference's bitmask helpers
(gnark/utils/oprf.go:194-315 — SetBitmaskForLocations,
SetBitmaskForLocationsWithBoundaries; studied and re-implemented):

  - locations are (pos, len) byte ranges in the LOGICAL data stream
  - each cipher block may carry fewer than block_size real bytes
    ("boundary"); logical positions are mapped to physical chunk
    positions block by block
  - overlapping locations are rejected; out-of-bounds is rejected
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Location:
    pos: int       # byte offset in the logical data stream
    length: int    # byte length


def _check_no_overlap(locations):
    locs = sorted(locations, key=lambda l: l.pos)
    for a, b in zip(locs, locs[1:]):
        if a.pos + a.length > b.pos:
            raise ValueError(
                f"locations overlap: [{a.pos},{a.pos + a.length}) and "
                f"[{b.pos},{b.pos + b.length})")


def set_bitmask_for_locations(total_bits: int, locations) -> list:
    """Full-block case: logical position == physical position."""
    _check_no_overlap(locations)
    bits = [0] * total_bits
    for loc in locations:
        p, l = loc.pos * 8, loc.length * 8
        if p + l > total_bits:
            raise ValueError(
                f"location out of bounds: pos {loc.pos} len {loc.length}")
        for i in range(p, p + l):
            bits[i] = 1
    return bits


def set_bitmask_with_boundaries(total_bits: int, locations, boundaries,
                                block_size: int) -> list:
    """Boundary-aware case: block b physically occupies
    [b*block_size, (b+1)*block_size) but logically carries only
    boundaries[b] bytes; logical target ranges are intersected with each
    block's logical span and mapped to physical bit positions."""
    _check_no_overlap(locations)
    bits = [0] * total_bits
    for loc in locations:
        target_end = loc.pos + loc.length
        logical_pos = 0
        for block_idx, boundary in enumerate(boundaries):
            phys_start = block_idx * block_size
            logical_end = logical_pos + boundary
            lo = max(loc.pos, logical_pos)
            hi = min(target_end, logical_end)
            for logical_byte in range(lo, hi):
                phys_byte = phys_start + (logical_byte - logical_pos)
                for bit in range(8):
                    idx = phys_byte * 8 + bit
                    if idx < total_bits:
                        bits[idx] = 1
            logical_pos = logical_end
    return bits


def compute_bitmask(total_bits: int, locations, boundaries,
                    block_size: int) -> list:
    """Dispatch exactly like the reference prover
    (gnark/libraries/prover/impl/provers.go:426-438): simple mapping when
    every block is full, boundary-aware otherwise."""
    locs = [l if isinstance(l, Location) else Location(*l) for l in locations]
    if all(b == block_size for b in boundaries):
        return set_bitmask_for_locations(total_bits, locs)
    return set_bitmask_with_boundaries(total_bits, locs, boundaries,
                                       block_size)

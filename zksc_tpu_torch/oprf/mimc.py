"""MiMC hash over BN254 Fr — gnark-crypto parity.

Implements the exact construction of gnark-crypto's `ecc/bn254/fr/mimc`
(behavior studied from the reference's use at gnark/utils/oprf.go:146-158 and
the gnark in-circuit counterpart std/hash/mimc used by
gnark/circuits/toprf/toprf.go:129-141; algorithm is public):

  - 110 rounds, S-box x^5:  m <- (m + h + c_i)^5,  encrypt(m) = m' + h
  - round constants: keccak-256 chain seeded with "seed" —
      x = K("seed");  repeat: x = K(x), c_i = int_be(x) mod r
    (legacy Keccak, Ethereum padding — see utils/keccak.py)
  - Miyaguchi-Preneel chaining:  h <- encrypt(m) + h + m   (h0 = 0)
  - byte-level Write: each write of <= 32 bytes is one big-endian field
    element block, left-padded with zeros; blocks >= r are rejected.

Cross-checked structurally (no Go toolchain in this container, so no binary
cross-check): constants derivation, round count, S-box, and chaining follow
the published gnark-crypto v0.12+ source layout exactly.
"""
from __future__ import annotations

from ..utils.keccak import keccak256

Q = 21888242871839275222246405745257275088548364400416034343698204186575808495617
N_ROUNDS = 110
BLOCK_SIZE = 32

_SEED = b"seed"


def _constants():
    out = []
    x = keccak256(_SEED)
    for _ in range(N_ROUNDS):
        x = keccak256(x)
        out.append(int.from_bytes(x, "big") % Q)
    return out


CONSTANTS = _constants()


def mimc_encrypt(m: int, h: int) -> int:
    """gnark-crypto encrypt: 110 x^5 rounds keyed by h, final +h."""
    for c in CONSTANTS:
        t = (m + h + c) % Q
        t2 = t * t % Q
        m = t2 * t2 % Q * t % Q
    return (m + h) % Q


def mimc_hash(values) -> int:
    """Miyaguchi-Preneel chain over field elements (the in-circuit Sum():
    h <- h + encrypt(m) + m), h0 = 0. Returns the digest as an int."""
    h = 0
    for v in values:
        m = int(v) % Q
        h = (mimc_encrypt(m, h) + h + m) % Q
    return h


def _bytes_to_blocks(data: bytes) -> list:
    """gnark-crypto digest.Write semantics: a short write (< 32 bytes) is one
    left-padded block; longer writes split into 32-byte blocks, each a
    big-endian field element that must be canonical (< r)."""
    if len(data) == 0:
        raise ValueError("empty write")
    if len(data) < BLOCK_SIZE:
        data = bytes(BLOCK_SIZE - len(data)) + data
    if len(data) % BLOCK_SIZE:
        raise ValueError("write length must pad to 32-byte blocks")
    blocks = []
    for off in range(0, len(data), BLOCK_SIZE):
        v = int.from_bytes(data[off:off + BLOCK_SIZE], "big")
        if v >= Q:
            raise ValueError("MiMC block is not a canonical field element")
        blocks.append(v)
    return blocks


def mimc_hash_bytes(*chunks: bytes) -> int:
    """The reference's hashToScalar (gnark/utils/oprf.go:146-158): each chunk
    is one hasher.Write (empty chunk -> single zero byte), digest returned as
    a big-endian integer."""
    blocks = []
    for c in chunks:
        blocks.extend(_bytes_to_blocks(c if len(c) else b"\x00"))
    return mimc_hash(blocks)


def int_bytes(v: int) -> bytes:
    """big.Int.Bytes() — minimal big-endian encoding, empty for zero."""
    if v == 0:
        return b""
    return v.to_bytes((v.bit_length() + 7) // 8, "big")

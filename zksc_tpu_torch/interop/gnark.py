"""gnark-crypto BN254 serialization codecs: compressed points, Groth16
verifying keys and proofs.

Byte-format parity with gnark's binary encodings (behavior studied from the
reference's embedded verifying keys, gnark/libraries/verifier/impl/
library.go:92-160 — the go:embed vk.* blobs under impl/generated/ — and
gnark's proof WriteTo/ReadFrom used at libraries/prover/impl/provers.go:185;
format re-implemented from the observed bytes + the public gnark-crypto
marshal conventions):

  G1 point: 32 bytes big-endian x, top 2 bits = flags
            (0b10 compressed/smallest-y, 0b11 compressed/largest-y,
             0b01 point at infinity, 0b00 uncompressed prefix -> 64 bytes)
  G2 point: 64 bytes [x.A1 | x.A0] big-endian, same flags in byte 0
  VerifyingKey: alpha G1 | beta G1 | beta G2 | gamma G2 | delta G1 |
            delta G2 | u32 K | K x G1 (the IC points) |
            u32 nbCommitments | per commitment u32 len + len x u32 indices |
            u32 nbPedersenKeys | per key 2 x G2 (pedersen G, GSigmaNeg)
  Proof:    Ar G1 | Bs G2 | Krs G1 | u32 nbCommitments | commitments G1... |
            commitmentPok G1

All integers big-endian. Parsing is strict: every point is decompressed,
canonicality-checked and subgroup-checked (G1: on-curve suffices, cofactor 1;
G2: full order-r check), mirroring gnark's strict deserialization.

The JAX package's ``interop/gnark.py`` on host ints; the vk and proof types
are the port's (``groth16.setup.VerifyingKey``, ``groth16.prove.Proof``),
so a proof made on the card leaves in gnark's bytes and an imported vk
verifies with the port's verifier.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..curve import bn254_host as host

P = host.P

FLAG_MASK = 0b11 << 6
FLAG_UNCOMPRESSED = 0b00 << 6
FLAG_INFINITY = 0b01 << 6
FLAG_SMALLEST = 0b10 << 6
FLAG_LARGEST = 0b11 << 6

_HALF = (P - 1) // 2


class GnarkFormatError(ValueError):
    pass


# ---------------- field square roots (host ints) ----------------

def _sqrt_fp(a: int) -> int | None:
    """sqrt mod p (p % 4 == 3): a^((p+1)/4); None if a is not a QR."""
    r = pow(a % P, (P + 1) // 4, P)
    return r if r * r % P == a % P else None


def _fp2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def _fp2_sqrt(c) -> tuple | None:
    """sqrt in Fp2 = Fp[u]/(u^2+1) via the norm method."""
    a, b = c[0] % P, c[1] % P
    if b == 0:
        r = _sqrt_fp(a)
        if r is not None:
            return (r, 0)
        # a is a non-residue: sqrt(a) = sqrt(-a) * u since u^2 = -1
        r = _sqrt_fp(-a % P)
        return None if r is None else (0, r)
    n = (a * a + b * b) % P
    lam = _sqrt_fp(n)
    if lam is None:
        return None
    x2 = (a + lam) * pow(2, -1, P) % P
    x = _sqrt_fp(x2)
    if x is None:
        x2 = (a - lam) % P * pow(2, -1, P) % P
        x = _sqrt_fp(x2)
        if x is None:
            return None
    y = b * pow(2 * x % P, -1, P) % P
    r = (x, y)
    return r if _fp2_mul(r, r) == (a, b) else None


def _lex_largest_fp(y: int) -> bool:
    return y > _HALF


def _lex_largest_fp2(y) -> bool:
    if y[1] != 0:
        return _lex_largest_fp(y[1])
    return _lex_largest_fp(y[0])


# ---------------- G1 ----------------

def g1_to_bytes(pt) -> bytes:
    """Affine (x, y) or None -> 32-byte gnark compressed encoding."""
    if pt is None:
        return bytes([FLAG_INFINITY]) + bytes(31)
    x, y = pt
    flag = FLAG_LARGEST if _lex_largest_fp(y) else FLAG_SMALLEST
    out = bytearray(int(x).to_bytes(32, "big"))
    out[0] |= flag
    return bytes(out)


def g1_from_bytes(data: bytes, offset: int = 0):
    """-> (point_or_None, next_offset). Strict: canonical x, on-curve."""
    if len(data) < offset + 32:
        raise GnarkFormatError("short G1")
    flag = data[offset] & FLAG_MASK
    if flag == FLAG_UNCOMPRESSED:
        if len(data) < offset + 64:
            raise GnarkFormatError("short uncompressed G1")
        x = int.from_bytes(data[offset:offset + 32], "big")
        y = int.from_bytes(data[offset + 32:offset + 64], "big")
        if x >= P or y >= P:
            raise GnarkFormatError("non-canonical G1 coordinate")
        pt = (x, y)
        if not host.g1_is_on_curve(pt):
            raise GnarkFormatError("G1 not on curve")
        return pt, offset + 64
    buf = bytearray(data[offset:offset + 32])
    buf[0] &= ~FLAG_MASK & 0xFF
    x = int.from_bytes(buf, "big")
    if flag == FLAG_INFINITY:
        if x != 0:
            raise GnarkFormatError("non-zero infinity encoding")
        return None, offset + 32
    if x >= P:
        raise GnarkFormatError("non-canonical G1 x")
    y = _sqrt_fp((x * x % P * x + 3) % P)
    if y is None:
        raise GnarkFormatError("G1 x not on curve")
    if _lex_largest_fp(y) != (flag == FLAG_LARGEST):
        y = P - y
    return (x, y), offset + 32


# ---------------- G2 ----------------

# twist curve: y^2 = x^3 + 3/(9+u)
_B2 = None


def _b2():
    global _B2
    if _B2 is None:
        nine_u = (9, 1)
        n = (nine_u[0] * nine_u[0] + nine_u[1] * nine_u[1]) % P
        ninv = pow(n, -1, P)
        inv = (nine_u[0] * ninv % P, (P - nine_u[1]) * ninv % P)
        _B2 = (3 * inv[0] % P, 3 * inv[1] % P)
    return _B2


def g2_to_bytes(pt) -> bytes:
    """Affine ((xa0, xa1), (ya0, ya1)) or None -> 64-byte compressed."""
    if pt is None:
        return bytes([FLAG_INFINITY]) + bytes(63)
    (xa0, xa1), (ya0, ya1) = pt
    flag = FLAG_LARGEST if _lex_largest_fp2((ya0, ya1)) else FLAG_SMALLEST
    out = bytearray(int(xa1).to_bytes(32, "big")
                    + int(xa0).to_bytes(32, "big"))
    out[0] |= flag
    return bytes(out)


def g2_from_bytes(data: bytes, offset: int = 0):
    if len(data) < offset + 64:
        raise GnarkFormatError("short G2")
    flag = data[offset] & FLAG_MASK
    if flag == FLAG_UNCOMPRESSED:
        if len(data) < offset + 128:
            raise GnarkFormatError("short uncompressed G2")
        vals = [int.from_bytes(data[offset + 32 * i:offset + 32 * (i + 1)],
                               "big") for i in range(4)]
        if any(v >= P for v in vals):
            raise GnarkFormatError("non-canonical G2 coordinate")
        pt = ((vals[1], vals[0]), (vals[3], vals[2]))
        if not host.g2_is_on_curve(pt) or not host.g2_in_subgroup(pt):
            raise GnarkFormatError("G2 not in subgroup")
        return pt, offset + 128
    buf = bytearray(data[offset:offset + 64])
    buf[0] &= ~FLAG_MASK & 0xFF
    xa1 = int.from_bytes(buf[:32], "big")
    xa0 = int.from_bytes(buf[32:], "big")
    if flag == FLAG_INFINITY:
        if xa0 or xa1:
            raise GnarkFormatError("non-zero infinity encoding")
        return None, offset + 64
    if xa0 >= P or xa1 >= P:
        raise GnarkFormatError("non-canonical G2 x")
    x = (xa0, xa1)
    x3 = _fp2_mul(_fp2_mul(x, x), x)
    b = _b2()
    rhs = ((x3[0] + b[0]) % P, (x3[1] + b[1]) % P)
    y = _fp2_sqrt(rhs)
    if y is None:
        raise GnarkFormatError("G2 x not on curve")
    if _lex_largest_fp2(y) != (flag == FLAG_LARGEST):
        y = ((P - y[0]) % P, (P - y[1]) % P)
    pt = (x, y)
    if not host.g2_in_subgroup(pt):
        raise GnarkFormatError("G2 not in subgroup")
    return pt, offset + 64


# ---------------- VerifyingKey ----------------

@dataclass
class GnarkVerifyingKey:
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    ic: list
    public_and_commitment_committed: list = field(default_factory=list)
    pedersen_keys: list = field(default_factory=list)   # [(G2, G2)]

    @property
    def n_public(self) -> int:
        return len(self.ic) - 1

    @property
    def n_commitments(self) -> int:
        return len(self.public_and_commitment_committed)


def _u32s(data: bytes, off: int, n: int = 1) -> list:
    """n big-endian u32 at off; a short blob is a format error (the JAX
    package lets struct.error escape there)."""
    if len(data) < off + 4 * n:
        raise GnarkFormatError("truncated")
    return list(struct.unpack_from(f">{n}I", data, off))


def parse_vk(data: bytes) -> GnarkVerifyingKey:
    """Strict parse of a gnark Groth16 VerifyingKey blob (all 6 reference
    vk.* files parse fully, every point subgroup-checked)."""
    off = 0
    alpha_g1, off = g1_from_bytes(data, off)
    beta_g1, off = g1_from_bytes(data, off)
    beta_g2, off = g2_from_bytes(data, off)
    gamma_g2, off = g2_from_bytes(data, off)
    delta_g1, off = g1_from_bytes(data, off)
    delta_g2, off = g2_from_bytes(data, off)
    if len(data) < off + 4:
        raise GnarkFormatError("missing IC count")
    (k,) = _u32s(data, off)
    off += 4
    ic = []
    for _ in range(k):
        pt, off = g1_from_bytes(data, off)
        ic.append(pt)
    (ncomm,) = _u32s(data, off)
    off += 4
    committed = []
    for _ in range(ncomm):
        (ln,) = _u32s(data, off)
        off += 4
        idxs = _u32s(data, off, ln)
        off += 4 * ln
        committed.append(idxs)
    (nped,) = _u32s(data, off)
    off += 4
    pedersen = []
    for _ in range(nped):
        g, off = g2_from_bytes(data, off)
        gsn, off = g2_from_bytes(data, off)
        pedersen.append((g, gsn))
    if off != len(data):
        raise GnarkFormatError(f"{len(data) - off} trailing bytes")
    return GnarkVerifyingKey(
        alpha_g1=alpha_g1, beta_g1=beta_g1, beta_g2=beta_g2,
        gamma_g2=gamma_g2, delta_g1=delta_g1, delta_g2=delta_g2, ic=ic,
        public_and_commitment_committed=committed, pedersen_keys=pedersen)


def write_vk(vk: GnarkVerifyingKey) -> bytes:
    out = bytearray()
    out += g1_to_bytes(vk.alpha_g1)
    out += g1_to_bytes(vk.beta_g1)
    out += g2_to_bytes(vk.beta_g2)
    out += g2_to_bytes(vk.gamma_g2)
    out += g1_to_bytes(vk.delta_g1)
    out += g2_to_bytes(vk.delta_g2)
    out += struct.pack(">I", len(vk.ic))
    for pt in vk.ic:
        out += g1_to_bytes(pt)
    out += struct.pack(">I", len(vk.public_and_commitment_committed))
    for idxs in vk.public_and_commitment_committed:
        out += struct.pack(">I", len(idxs))
        for i in idxs:
            out += struct.pack(">I", i)
    out += struct.pack(">I", len(vk.pedersen_keys))
    for g, gsn in vk.pedersen_keys:
        out += g2_to_bytes(g)
        out += g2_to_bytes(gsn)
    return bytes(out)


def vk_to_zksc(gvk: GnarkVerifyingKey):
    """Imported gnark vk -> the port's VerifyingKey (drops the
    prover-side beta_g1/delta_g1 and any commitment machinery)."""
    from ..groth16.setup import VerifyingKey
    if gvk.n_commitments:
        raise GnarkFormatError(
            "commitment-carrying circuits need the pedersen verifier "
            "(logderivlookup AES vks); import supports the plain R1CS path")
    return VerifyingKey(alpha_g1=gvk.alpha_g1, beta_g2=gvk.beta_g2,
                        gamma_g2=gvk.gamma_g2, delta_g2=gvk.delta_g2,
                        ic=list(gvk.ic), digest="gnark-import")


def zksc_to_gnark_vk(vk, pk=None) -> GnarkVerifyingKey:
    """The port's (vk, pk) -> gnark-format VerifyingKey (beta_g1/delta_g1 come from
    the proving key; gnark stores them in the vk)."""
    return GnarkVerifyingKey(
        alpha_g1=vk.alpha_g1,
        beta_g1=pk.beta_g1 if pk is not None else None,
        beta_g2=vk.beta_g2, gamma_g2=vk.gamma_g2,
        delta_g1=pk.delta_g1 if pk is not None else None,
        delta_g2=vk.delta_g2, ic=list(vk.ic))


# ---------------- Proof ----------------

def write_proof(proof) -> bytes:
    """The port's groth16.Proof -> gnark binary proof (Ar | Bs | Krs | 0 comms)."""
    out = bytearray()
    out += g1_to_bytes(proof.a)
    out += g2_to_bytes(proof.b)
    out += g1_to_bytes(proof.c)
    out += struct.pack(">I", 0)          # no commitments
    out += g1_to_bytes(None)             # commitmentPok (identity)
    return bytes(out)


def parse_proof(data: bytes):
    """gnark binary proof -> the port's groth16.Proof (strict, subgroup-checked)."""
    from ..groth16.prove import Proof
    off = 0
    a, off = g1_from_bytes(data, off)
    b, off = g2_from_bytes(data, off)
    c, off = g1_from_bytes(data, off)
    (ncomm,) = _u32s(data, off)
    off += 4
    comms = []
    for _ in range(ncomm):
        pt, off = g1_from_bytes(data, off)
        comms.append(pt)
    _pok, off = g1_from_bytes(data, off)
    if off != len(data):
        raise GnarkFormatError(f"{len(data) - off} trailing bytes")
    if a is None or b is None or c is None:
        raise GnarkFormatError("infinity proof point")
    return Proof(a=a, b=b, c=c)

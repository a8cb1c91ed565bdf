"""(Threshold) OPRF over BabyJubJub: request - evaluate - finalize, with DLEQ
proofs and Shamir threshold shares — reference-protocol parity.

Protocol matches the reference's host-side OPRF layer bit-for-bit
(gnark/utils/oprf.go:33-143, toprf.go:20-151, dleq.go:22-82 — behavior
studied, implemented fresh over our own BabyJubJub/MiMC hosts):

  request:  secret bytes -> <=2 31-byte LITTLE-ENDIAN field elements;
            H = [MiMC(s0, s1, domain)] * Base; random mask r; masked = [r]H
  evaluate: on-curve + small-subgroup check ([8]P != identity);
            response = [sk]masked; DLEQ proof over cofactor-cleared points
            (challenge transcript: base, [8]xG, vG, vH, H, [8]xH)
  finalize: verify DLEQ; unmasked = [mask^-1]response;
            output = MiMC(x, y, s0, s1)   (byte-level gnark hasher semantics)
  threshold: Shamir shares (1-based x), per-share evaluate + DLEQ,
            Lagrange recombination at x=0 of responses AND share public keys
            (the latter must reconstruct the registered server key).
"""
from __future__ import annotations

import secrets
from dataclasses import dataclass

from . import babyjubjub as bjj
from .mimc import int_bytes, mimc_hash_bytes

L = bjj.L_ORDER
BYTES_PER_ELEMENT = 31


def split_secret_elements(data: bytes) -> list:
    """Secret bytes -> up to 2 field elements of <= 31 bytes each,
    LITTLE-endian (the reference reverses each chunk before SetBytes:
    gnark/utils/oprf.go:44-50, BEtoLE)."""
    if len(data) > 2 * BYTES_PER_ELEMENT:
        raise ValueError("secret data longer than 62 bytes")
    if len(data) > BYTES_PER_ELEMENT:
        chunks = [data[:BYTES_PER_ELEMENT], data[BYTES_PER_ELEMENT:]]
    else:
        chunks = [data, b""]
    return [int.from_bytes(c, "little") for c in chunks]


def hash_points_to_scalar(*points) -> int:
    """MiMC over (x, y) minimal big-endian byte encodings
    (gnark/utils/oprf.go:160-176 HashPointsToScalar)."""
    chunks = []
    for x, y in points:
        chunks.append(int_bytes(x))
        chunks.append(int_bytes(y))
    return mimc_hash_bytes(*chunks)


def hash_to_point(data: bytes, domain_separator: bytes = b""):
    """H = [MiMC(s0.bytes, s1.bytes, domain)] * Base (gnark/utils/oprf.go:
    178-185 HashToCurve; same caveat as reference: not a uniform map)."""
    s0, s1 = split_secret_elements(data)
    scalar = mimc_hash_bytes(int_bytes(s0), int_bytes(s1),
                             bytes(domain_separator))
    return bjj.mul(bjj.BASE, scalar)


# ---------------- DLEQ (Chaum-Pedersen, cofactor-cleared) ----------------

@dataclass
class DLEQProof:
    c: int
    r: int


def dleq_prove(sk: int, H, rng=None) -> DLEQProof:
    """Prove log_Base([sk]Base) == log_H([sk]H), transcript per
    gnark/utils/dleq.go:22-57: points cleared by cofactor 8, effective
    secret 8*sk, challenge over (Base, xGc, vG, vH, H, xHc)."""
    if rng is None:
        rng = lambda: secrets.randbelow(L)
    xG = bjj.mul(bjj.BASE, sk)
    xH = bjj.mul(H, sk)
    xGc = bjj.clear_cofactor(xG)
    xHc = bjj.clear_cofactor(xH)
    if xGc == bjj.IDENTITY or xHc == bjj.IDENTITY:
        raise ValueError("degenerate DLEQ statement (small-subgroup point)")
    effective = 8 * sk % L
    v = rng()
    vG = bjj.mul(bjj.BASE, v)
    vH = bjj.mul(H, v)
    c = hash_points_to_scalar(bjj.BASE, xGc, vG, vH, H, xHc)
    r = (v - c * effective) % L
    return DLEQProof(c=c, r=r)


def dleq_verify(proof: DLEQProof, xG, xH, H) -> bool:
    """gnark/utils/dleq.go:59-84: vG = [r]Base + [c][8]xG,
    vH = [r]H + [c][8]xH, challenge recomputation."""
    xGc = bjj.clear_cofactor(xG)
    xHc = bjj.clear_cofactor(xH)
    if xGc == bjj.IDENTITY or xHc == bjj.IDENTITY:
        return False
    vG = bjj.add(bjj.mul(bjj.BASE, proof.r), bjj.mul(xGc, proof.c))
    vH = bjj.add(bjj.mul(H, proof.r), bjj.mul(xHc, proof.c))
    return hash_points_to_scalar(bjj.BASE, xGc, vG, vH, H, xHc) == proof.c


# ---------------- single-server OPRF ----------------

@dataclass
class OPRFRequest:
    mask: int
    masked_point: tuple
    secret_elements: list


@dataclass
class OPRFResponse:
    evaluated: tuple
    public_key: tuple        # [sk]Base (the server/share public key)
    dleq: DLEQProof


def generate_request(data: bytes, rng=None,
                     domain_separator: bytes = b"") -> OPRFRequest:
    if len(domain_separator) > BYTES_PER_ELEMENT:
        raise ValueError("domain separator longer than 31 bytes")
    if rng is None:
        rng = lambda: secrets.randbelow(L - 1) + 1
    h = hash_to_point(data, domain_separator)
    mask = rng()
    if mask % L == 0:
        raise ValueError("mask must be non-zero")
    return OPRFRequest(mask=mask, masked_point=bjj.mul(h, mask),
                       secret_elements=split_secret_elements(data))


def _check_point(p, what: str):
    if not bjj.is_on_curve(p):
        raise ValueError(f"{what} is not on curve")
    if bjj.clear_cofactor(p) == bjj.IDENTITY:
        raise ValueError(f"{what} is in a small subgroup")


def evaluate(sk: int, masked_point, rng=None) -> OPRFResponse:
    """Server side: respond to a blinded request (gnark/utils/oprf.go:75-108)."""
    _check_point(masked_point, "request point")
    evaluated = bjj.mul(masked_point, sk)
    pub = bjj.mul(bjj.BASE, sk)
    proof = dleq_prove(sk, masked_point, rng)
    return OPRFResponse(evaluated=evaluated, public_key=pub, dleq=proof)


def _output_hash(unmasked, secret_elements) -> int:
    s0, s1 = secret_elements
    return mimc_hash_bytes(int_bytes(unmasked[0]), int_bytes(unmasked[1]),
                           int_bytes(s0), int_bytes(s1))


def finalize(request: OPRFRequest, response: OPRFResponse,
             server_public=None) -> int:
    """Client side (gnark/utils/oprf.go:110-143): validate, verify DLEQ,
    deblind, hash. server_public defaults to the response's public key."""
    pub = server_public if server_public is not None else response.public_key
    _check_point(pub, "server public key")
    _check_point(response.evaluated, "evaluated point")
    if not dleq_verify(response.dleq, pub, response.evaluated,
                       request.masked_point):
        raise ValueError("DLEQ verification failed")
    unmasked = bjj.mul(response.evaluated, pow(request.mask, -1, L))
    return _output_hash(unmasked, request.secret_elements)


# ---------------- threshold (Shamir) ----------------

@dataclass
class KeyShare:
    index: int          # x-coordinate (1-based, reference Share.Index)
    secret: int
    public_key: tuple


def generate_threshold_keys(n: int, threshold: int, rng=None):
    """Returns (master_public_key, [KeyShare]*n). Polynomial degree
    threshold-1 per the reference (gnark/utils/toprf.go:20-55): any
    `threshold` shares recombine. NOTE reference semantics: threshold IS the
    recombination count (toprf.Threshold = 1 means single-share)."""
    if rng is None:
        rng = lambda: secrets.randbelow(L - 1) + 1
    sk = rng()
    coeffs = [rng() for _ in range(threshold - 1)]
    shares = []
    for i in range(1, n + 1):
        acc = sk
        for j, cf in enumerate(coeffs):
            acc = (acc + cf * pow(i, j + 1, L)) % L
        shares.append(KeyShare(index=i, secret=acc,
                               public_key=bjj.mul(bjj.BASE, acc)))
    return bjj.mul(bjj.BASE, sk), shares


def lagrange_coeff(indices: list, i: int) -> int:
    """Lagrange basis coefficient at x=0 for share x-coordinate i
    (reference Coeff uses 0-based idx + 1 == our 1-based index)."""
    num, den = 1, 1
    for j in indices:
        if j == i:
            continue
        num = num * j % L
        den = den * ((j - i) % L) % L
    return num * pow(den, -1, L) % L


def threshold_finalize(request: OPRFRequest, responses: dict,
                       server_public=None) -> int:
    """responses: {share_index: OPRFResponse}; needs `threshold` entries.
    Mirrors TOPRFFinalize (gnark/utils/toprf.go:96-151): share public keys
    must reconstruct the server key (when given), every DLEQ verifies,
    responses Lagrange-combine at x=0, then unmask + hash."""
    indices = sorted(responses)
    if server_public is not None:
        recon = bjj.IDENTITY
        for i in indices:
            lam = lagrange_coeff(indices, i)
            recon = bjj.add(recon, bjj.mul(responses[i].public_key, lam))
        if recon != server_public:
            raise ValueError("share public keys do not reconstruct server key")
    combined = bjj.IDENTITY
    for i in indices:
        resp = responses[i]
        _check_point(resp.evaluated, f"evaluated point {i}")
        _check_point(resp.public_key, f"share public key {i}")
        if not dleq_verify(resp.dleq, resp.public_key, resp.evaluated,
                           request.masked_point):
            raise ValueError(f"DLEQ verification failed for share {i}")
        lam = lagrange_coeff(indices, i)
        combined = bjj.add(combined, bjj.mul(resp.evaluated, lam))
    unmasked = bjj.mul(combined, pow(request.mask, -1, L))
    return _output_hash(unmasked, request.secret_elements)

"""snarkjs artifact codecs: .zkey / .wtns containers and vkey JSON.

Fills the snarkjs-interop role of the reference's snarkjs operator
(js/src/snarkjs/operator.ts:92-118 loads circuit_final.zkey and produces
.wtns witnesses; SURVEY.md §2.5 item 8 lists the formats as a required
codec). The binary container is iden3's binfile layout:

  magic[4] | u32 version | u32 nSections |
  repeat: u32 sectionType | u64 sectionSize | payload

.zkey (Groth16, version 1) sections:
  1 header       u32 protocolId (1 = groth16)
  2 g16 header   u32 n8q, q LE, u32 n8r, r LE, u32 nVars, u32 nPublic,
                 u32 domainSize, alpha1, beta1, beta2, gamma2, delta1, delta2
  3 IC           (nPublic+1) G1
  4 coeffs       u32 nCoeffs, then {u32 matrix(0=A,1=B), u32 constraint,
                 u32 signal, fr value} — the sparse A/B rows used for
                 witness->A,B evaluation by the snarkjs prover
  5 pointsA      nVars G1        6 pointsB1  nVars G1
  7 pointsB2     nVars G2        8 pointsC   (nVars-nPublic-1) G1
  9 pointsH      domainSize G1   10 contributions (ignored on read)

All field elements little-endian **Montgomery** form (R = 2^256 mod p).
Points are uncompressed (x, y); the point at infinity is (0, 0).

.wtns (version 2) sections:
  1 header  u32 n8, r LE, u32 nWitness
  2 values  nWitness x n8 little-endian **standard** form

H-basis note: the port's proving key, as the JAX package's, keeps the H
query in the tau-power basis [tau^k Z(tau)/delta]G1 (bit-reversed on the
device). Export writes that basis in natural order. snarkjs' own zkeys store
a Lagrange-shifted basis for its 4n-FFT prover; parsing a real snarkjs zkey
therefore yields query tables usable by *its* prover semantics — callers
importing one for this prover must supply basis='snarkjs' so the H pipeline
can account for it (not implemented, in the reference either; no reference
zkey blob ships in the checkout to validate against, .MISSING_LARGE_BLOBS).

The JAX package's ``interop/snarkjs.py``: host ints throughout, except that
``write_zkey`` reads the port's device ``ProvingKey`` and ``read_zkey``
checks the B2 query's subgroup membership on the device.
"""
from __future__ import annotations

import io
import struct
import time

from ..curve import bn254_host as host
from ..device import resolve_device
from ..utils.logging import Logger, default_logger

P = host.P
R_MOD = host.R
_MONT_P = (1 << 256) % P
_MONT_R = (1 << 256) % R_MOD
_MONT_P_INV = pow(_MONT_P, -1, P)
_MONT_R_INV = pow(_MONT_R, -1, R_MOD)

ZKEY_MAGIC = b"zkey"
WTNS_MAGIC = b"wtns"


class SnarkjsFormatError(ValueError):
    pass


# ---------------- binfile container ----------------

def _write_binfile(magic: bytes, version: int, sections: list) -> bytes:
    """sections: list of (type, payload bytes)."""
    out = io.BytesIO()
    out.write(magic)
    out.write(struct.pack("<II", version, len(sections)))
    for stype, payload in sections:
        out.write(struct.pack("<IQ", stype, len(payload)))
        out.write(payload)
    return out.getvalue()


def _read_binfile(data: bytes, magic: bytes) -> dict:
    if data[:4] != magic:
        raise SnarkjsFormatError(f"bad magic {data[:4]!r}, want {magic!r}")
    version, n_sections = struct.unpack_from("<II", data, 4)
    sections = {}
    off = 12
    for _ in range(n_sections):
        stype, size = struct.unpack_from("<IQ", data, off)
        off += 12
        sections.setdefault(stype, data[off:off + size])
        off += size
    if off != len(data):
        raise SnarkjsFormatError("trailing bytes after last section")
    return {"version": version, "sections": sections}


# ---------------- field / point codecs ----------------

def _fq_to_mont_bytes(v: int) -> bytes:
    return (v * _MONT_P % P).to_bytes(32, "little")


def _fq_from_mont_bytes(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= P:
        raise SnarkjsFormatError("Fq element out of range")
    return v * _MONT_P_INV % P


def _fr_to_mont_bytes(v: int) -> bytes:
    return (v * _MONT_R % R_MOD).to_bytes(32, "little")


def _fr_from_mont_bytes(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= R_MOD:
        raise SnarkjsFormatError("Fr element out of range")
    return v * _MONT_R_INV % R_MOD


def _g1_bytes(pt) -> bytes:
    if pt is None:
        return bytes(64)
    return _fq_to_mont_bytes(pt[0]) + _fq_to_mont_bytes(pt[1])


def _g1_from(b: bytes):
    x, y = _fq_from_mont_bytes(b[:32]), _fq_from_mont_bytes(b[32:64])
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if not host.g1_is_on_curve(pt):
        raise SnarkjsFormatError("G1 point not on curve")
    return pt


def _g2_bytes(pt) -> bytes:
    if pt is None:
        return bytes(128)
    (x0, x1), (y0, y1) = pt
    return (_fq_to_mont_bytes(x0) + _fq_to_mont_bytes(x1)
            + _fq_to_mont_bytes(y0) + _fq_to_mont_bytes(y1))


def _g2_from(b: bytes, subgroup: bool = True):
    """subgroup=False checks the curve only: the caller checks the order
    (``_check_g2_order``)."""
    x = (_fq_from_mont_bytes(b[:32]), _fq_from_mont_bytes(b[32:64]))
    y = (_fq_from_mont_bytes(b[64:96]), _fq_from_mont_bytes(b[96:128]))
    if x == (0, 0) and y == (0, 0):
        return None
    pt = (x, y)
    ok = host.g2_in_subgroup(pt) if subgroup else host.g2_is_on_curve(pt)
    if not ok:
        raise SnarkjsFormatError("G2 point not in the r-torsion subgroup")
    return pt


def _check_g2_order(pts: list, device) -> None:
    """r * P == O for every point of a G2 table, as one ladder by r over
    all of them on `device` (K3 on the card): the host check is one
    254-bit ladder in Python ints per point, minutes for a query of tens of
    thousands. On-curve points of order dividing r are exactly the
    r-torsion subgroup."""
    from ..fields.limb import Fp
    from ..ops import ec
    pts = [p for p in pts if p is not None]
    if not pts:
        return
    dev = ec.g2_points_to_device(Fp, pts, device=resolve_device(device))
    rP = ec.scale_points(ec.G2_OPS, dev, R_MOD)
    if not bool((rP.z == 0).all()):
        raise SnarkjsFormatError("G2 point not in the r-torsion subgroup")


# ---------------- zkey ----------------

def write_zkey(cs, pk, vk, logger: Logger | None = None) -> bytes:
    """Serialize (ConstraintSystem, ProvingKey, VerifyingKey) as a .zkey.

    The key's query tables are read from their device (the card's Jacobian
    limb tensors) through ``ops.ec``'s host affine conversion, section by
    section; each section's seconds go to `logger` (info, "zkey section").
    The coefficient section carries the A and B sparse rows of `cs` exactly
    as snarkjs stores them (matrix id 0/1; C rows are derivable and not
    stored, matching snarkjs)."""
    from ..fields.limb import Fp
    from ..ops import ec
    from ..ops.ntt import bit_reverse_perm

    logger = logger or default_logger()
    n_pub = cs.n_public
    n_vars = cs.n_wires
    n_priv = n_vars - n_pub - 1

    def g1_section(name, pts, n):
        t = time.perf_counter()
        head = ec.JacPoint(pts.x[:, :n], pts.y[:, :n], pts.z[:, :n])
        aff = ec.g1_jac_to_host_affine(Fp, head, P)
        if name == "h":
            # device H is bit-reversed; zkey stores natural tau-power order
            br = bit_reverse_perm(n)
            nat = [None] * n
            for i in range(n):
                nat[int(br[i])] = aff[i]
            aff = nat
        out = b"".join(_g1_bytes(pt) for pt in aff)
        logger.info("zkey section", section=name, points=n,
                    seconds=time.perf_counter() - t)
        return out

    s5 = g1_section("a", pk.a_query, n_vars)
    s6 = g1_section("b1", pk.b_g1_query, n_vars)
    t = time.perf_counter()
    b2_pts = ec.g2_jac_to_host_affine(Fp, pk.b_g2_query, P)[:n_vars]
    s7 = b"".join(_g2_bytes(pt) for pt in b2_pts)
    logger.info("zkey section", section="b2", points=n_vars,
                seconds=time.perf_counter() - t)
    s8 = g1_section("c", pk.c_query, n_priv)
    s9 = g1_section("h", pk.h_query, pk.domain_n)

    t = time.perf_counter()
    s1 = struct.pack("<I", 1)
    s2 = io.BytesIO()
    s2.write(struct.pack("<I", 32))
    s2.write(P.to_bytes(32, "little"))
    s2.write(struct.pack("<I", 32))
    s2.write(R_MOD.to_bytes(32, "little"))
    s2.write(struct.pack("<III", n_vars, n_pub, pk.domain_n))
    s2.write(_g1_bytes(pk.alpha_g1))
    s2.write(_g1_bytes(pk.beta_g1))
    s2.write(_g2_bytes(pk.beta_g2))
    s2.write(_g2_bytes(vk.gamma_g2))
    s2.write(_g1_bytes(pk.delta_g1))
    s2.write(_g2_bytes(pk.delta_g2))

    s3 = b"".join(_g1_bytes(pt) for pt in vk.ic)

    coeffs = []
    for k, (la, lb, _lc) in enumerate(cs.constraints):
        for m_id, lc in ((0, la), (1, lb)):
            for wire, coeff in lc.items():
                coeffs.append(struct.pack("<III", m_id, k, wire)
                              + _fr_to_mont_bytes(coeff % R_MOD))
    s4 = struct.pack("<I", len(coeffs)) + b"".join(coeffs)
    logger.info("zkey section", section="header, ic and coeffs",
                coeffs=len(coeffs), seconds=time.perf_counter() - t)

    return _write_binfile(ZKEY_MAGIC, 1, [
        (1, s1), (2, s2.getvalue()), (3, s3), (4, s4), (5, s5),
        (6, s6), (7, s7), (8, s8), (9, s9), (10, b""),
    ])


def read_zkey(data: bytes, device=None) -> dict:
    """Parse a .zkey into plain host structures. Every point is checked as
    the reference does; the B2 query's subgroup check runs on `device`
    (default "cuda").

    Returns dict with: n_vars, n_public, domain_size, alpha_g1, beta_g1,
    beta_g2, gamma_g2, delta_g1, delta_g2, ic, a_query, b_g1_query,
    b_g2_query, c_query, h_query (host affine tuples, None = infinity), and
    coeffs as (matrix, constraint, signal, value) tuples."""
    f = _read_binfile(data, ZKEY_MAGIC)
    sec = f["sections"]
    (protocol,) = struct.unpack_from("<I", sec[1], 0)
    if protocol != 1:
        raise SnarkjsFormatError(f"not a groth16 zkey (protocol {protocol})")
    s2 = sec[2]
    off = 0
    (n8q,) = struct.unpack_from("<I", s2, off); off += 4
    q = int.from_bytes(s2[off:off + n8q], "little"); off += n8q
    (n8r,) = struct.unpack_from("<I", s2, off); off += 4
    r = int.from_bytes(s2[off:off + n8r], "little"); off += n8r
    if (q, r) != (P, R_MOD):
        raise SnarkjsFormatError("not a BN254 zkey")
    n_vars, n_pub, domain = struct.unpack_from("<III", s2, off); off += 12
    alpha_g1 = _g1_from(s2[off:off + 64]); off += 64
    beta_g1 = _g1_from(s2[off:off + 64]); off += 64
    beta_g2 = _g2_from(s2[off:off + 128]); off += 128
    gamma_g2 = _g2_from(s2[off:off + 128]); off += 128
    delta_g1 = _g1_from(s2[off:off + 64]); off += 64
    delta_g2 = _g2_from(s2[off:off + 128]); off += 128

    def g1s(b):
        return [_g1_from(b[i:i + 64]) for i in range(0, len(b), 64)]

    def g2s(b):
        pts = [_g2_from(b[i:i + 128], subgroup=False)
               for i in range(0, len(b), 128)]
        _check_g2_order(pts, device)
        return pts

    (n_coeffs,) = struct.unpack_from("<I", sec[4], 0)
    coeffs = []
    off = 4
    for _ in range(n_coeffs):
        m_id, k, wire = struct.unpack_from("<III", sec[4], off)
        off += 12
        coeffs.append((m_id, k, wire, _fr_from_mont_bytes(sec[4][off:off + 32])))
        off += 32
    return {
        "n_vars": n_vars, "n_public": n_pub, "domain_size": domain,
        "alpha_g1": alpha_g1, "beta_g1": beta_g1, "beta_g2": beta_g2,
        "gamma_g2": gamma_g2, "delta_g1": delta_g1, "delta_g2": delta_g2,
        "ic": g1s(sec[3]), "coeffs": coeffs,
        "a_query": g1s(sec[5]), "b_g1_query": g1s(sec[6]),
        "b_g2_query": g2s(sec[7]), "c_query": g1s(sec[8]),
        "h_query": g1s(sec[9]),
    }


# ---------------- wtns ----------------

def write_wtns(witness) -> bytes:
    """Witness vector (ints) -> .wtns bytes (snarkjs wtnsCalculate output,
    js/src/snarkjs/operator.ts:92-106)."""
    vals = [int(v) % R_MOD for v in witness]
    s1 = struct.pack("<I", 32) + R_MOD.to_bytes(32, "little") + \
        struct.pack("<I", len(vals))
    s2 = b"".join(v.to_bytes(32, "little") for v in vals)
    return _write_binfile(WTNS_MAGIC, 2, [(1, s1), (2, s2)])


def read_wtns(data: bytes) -> list:
    f = _read_binfile(data, WTNS_MAGIC)
    s1 = f["sections"][1]
    (n8,) = struct.unpack_from("<I", s1, 0)
    r = int.from_bytes(s1[4:4 + n8], "little")
    if r != R_MOD:
        raise SnarkjsFormatError("not a BN254 witness file")
    (n_wit,) = struct.unpack_from("<I", s1, 4 + n8)
    s2 = f["sections"][2]
    if len(s2) != n_wit * n8:
        raise SnarkjsFormatError("witness section size mismatch")
    out = [int.from_bytes(s2[i * n8:(i + 1) * n8], "little")
           for i in range(n_wit)]
    for v in out:
        if v >= R_MOD:
            raise SnarkjsFormatError("witness value out of range")
    return out


# ---------------- verification key JSON ----------------

def vkey_to_json(vk) -> dict:
    """VerifyingKey -> snarkjs verification_key.json dict, so proofs from
    the port verify under snarkjs.groth16.verify (the reference's
    verify path, js/src/snarkjs/operator.ts:122-147)."""
    def g1(pt):
        return [str(pt[0]), str(pt[1]), "1"]

    def g2(pt):
        return [[str(pt[0][0]), str(pt[0][1])],
                [str(pt[1][0]), str(pt[1][1])], ["1", "0"]]

    return {
        "protocol": "groth16",
        "curve": "bn128",
        "nPublic": len(vk.ic) - 1,
        "vk_alpha_1": g1(vk.alpha_g1),
        "vk_beta_2": g2(vk.beta_g2),
        "vk_gamma_2": g2(vk.gamma_g2),
        "vk_delta_2": g2(vk.delta_g2),
        "IC": [g1(pt) for pt in vk.ic],
    }


def vkey_from_json(d: dict):
    from ..groth16.setup import VerifyingKey
    if d.get("protocol") != "groth16":
        raise SnarkjsFormatError("not a groth16 vkey")

    def g1(v):
        return (int(v[0]), int(v[1]))

    def g2(v):
        return ((int(v[0][0]), int(v[0][1])), (int(v[1][0]), int(v[1][1])))

    return VerifyingKey(
        alpha_g1=g1(d["vk_alpha_1"]), beta_g2=g2(d["vk_beta_2"]),
        gamma_g2=g2(d["vk_gamma_2"]), delta_g2=g2(d["vk_delta_2"]),
        ic=[g1(p) for p in d["IC"]],
    )

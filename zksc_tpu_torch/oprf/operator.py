"""OPRF/TOPRF protocol operator: the full threshold-OPRF client/server
surface with gnark-parity wire formats.

Fills the role of the reference's OPRF operator + FFI JSON shims
(js/src/gnark/toprf.ts:17-152 driving the exported GenerateThresholdKeys /
GenerateOPRFRequestData / OPRFEvaluate / TOPRFFinalize of
gnark/libraries/{prover,verifier}/oprf/library.go — wire shapes mirrored
field-for-field; base64 byte fields, share indices, DLEQ c/r scalars).

Point encoding: gnark-crypto twisted-Edwards compressed form — 32 bytes
little-endian y with the x-sign flag (x lexicographically largest) in the
most significant bit of the last byte. Scalars: big-endian minimal bytes
(`big.Int.Bytes()`).
"""
from __future__ import annotations

import base64

from . import babyjubjub as bjj
from .babyjubjub import Q
from .oprf import (
    DLEQProof, OPRFRequest, OPRFResponse, evaluate, generate_request,
    generate_threshold_keys, lagrange_coeff, threshold_finalize,
)

_HALF = (Q - 1) // 2
_SIGN_MASK = 0x80


# ---------------- Tonelli-Shanks sqrt mod Q (2-adicity 28) ----------------

def _sqrt_q(a: int) -> int | None:
    a %= Q
    if a == 0:
        return 0
    if pow(a, (Q - 1) // 2, Q) != 1:
        return None
    # Q - 1 = q * 2^s with q odd
    q, s = Q - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 5                      # 5 is a quadratic non-residue mod BN254 r
    while pow(z, (Q - 1) // 2, Q) == 1:
        z += 1
    m, c, t, r = s, pow(z, q, Q), pow(a, q, Q), pow(a, (q + 1) // 2, Q)
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % Q
            i += 1
        b = pow(c, 1 << (m - i - 1), Q)
        m, c = i, b * b % Q
        t, r = t * c % Q, r * b % Q
    return r


# ---------------- point/scalar codecs (gnark-crypto parity) ----------------

def point_to_bytes(p) -> bytes:
    """Twisted-Edwards compressed: LE y, x-sign in MSB of the last byte."""
    x, y = p
    buf = bytearray(int(y).to_bytes(32, "little"))
    if int(x) > _HALF:
        buf[31] |= _SIGN_MASK
    return bytes(buf)


def point_from_bytes(data: bytes):
    if len(data) != 32:
        raise ValueError("point encoding must be 32 bytes")
    buf = bytearray(data)
    sign = bool(buf[31] & _SIGN_MASK)
    buf[31] &= 0x7F
    y = int.from_bytes(buf, "little")
    if y >= Q:
        raise ValueError("non-canonical y")
    # a x^2 + y^2 = 1 + d x^2 y^2  =>  x^2 = (1 - y^2) / (a - d y^2)
    num = (1 - y * y) % Q
    den = (bjj.A - bjj.D * y * y) % Q
    x = _sqrt_q(num * pow(den, -1, Q) % Q)
    if x is None:
        raise ValueError("y not on curve")
    if (x > _HALF) != sign:
        x = (Q - x) % Q
    p = (x, y)
    if not bjj.is_on_curve(p):
        raise ValueError("decoded point not on curve")
    return p


def scalar_to_bytes(v: int) -> bytes:
    v = int(v)
    return v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big")


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


# ---------------- the operator ----------------

class OPRFOperator:
    """Local (in-process) implementation of the reference's OPRFOperator
    interface: threshold keygen, request generation, server-side evaluate,
    client-side finalize — wire shapes identical to the gnark FFI JSON — plus
    TOPRF proof generation/verification through the Groth16 engine's
    `<cipher>-toprf` circuits on `device` (default "cuda")."""

    def __init__(self, algorithm: str = "chacha20", rng=None, device=None):
        self.algorithm = algorithm
        self._rng = rng
        self.device = device

    # --- protocol surface (gnark/libraries/*/oprf/library.go parity) ---

    def generate_threshold_keys(self, total: int, threshold: int) -> dict:
        master_pub, shares = generate_threshold_keys(total, threshold,
                                                     rng=self._rng)
        # reconstruct sk for the wire's privateKey field the way the
        # reference returns it (TOPRFGenerateSharedKey returns the master
        # private key too); recompute from threshold shares
        idxs = [s.index for s in shares[:threshold]]
        sk = sum(lagrange_coeff(idxs, s.index) * s.secret
                 for s in shares[:threshold]) % bjj.L_ORDER
        return {
            "publicKey": _b64(point_to_bytes(master_pub)),
            "privateKey": _b64(scalar_to_bytes(sk)),
            "shares": [{
                "index": s.index,
                "publicKey": _b64(point_to_bytes(s.public_key)),
                "privateKey": _b64(scalar_to_bytes(s.secret)),
            } for s in shares],
        }

    def generate_oprf_request_data(self, data: bytes,
                                   domain_separator: str | bytes) -> dict:
        ds = (domain_separator.encode() if isinstance(domain_separator, str)
              else bytes(domain_separator))
        req = generate_request(data, rng=self._rng, domain_separator=ds)
        se = req.secret_elements + [0] * (2 - len(req.secret_elements))
        return {
            "mask": _b64(scalar_to_bytes(req.mask)),
            "maskedData": _b64(point_to_bytes(req.masked_point)),
            "secretElements": [_b64(scalar_to_bytes(se[0])),
                               _b64(scalar_to_bytes(se[1]))],
        }

    def evaluate_oprf(self, server_private: str | bytes,
                      masked_data: str | bytes) -> dict:
        sk = int.from_bytes(self._bytes(server_private), "big")
        masked = point_from_bytes(self._bytes(masked_data))
        resp = evaluate(sk, masked, rng=self._rng)
        return {
            "evaluated": _b64(point_to_bytes(resp.evaluated)),
            "c": _b64(scalar_to_bytes(resp.dleq.c)),
            "r": _b64(scalar_to_bytes(resp.dleq.r)),
        }

    def finalise_oprf(self, server_public_key: str | bytes, request: dict,
                      responses: list) -> dict:
        req = OPRFRequest(
            mask=int.from_bytes(self._bytes(request["mask"]), "big"),
            masked_point=point_from_bytes(self._bytes(request["maskedData"])),
            secret_elements=[
                int.from_bytes(self._bytes(b), "big")
                for b in request["secretElements"]],
        )
        resp_map = {}
        for i, r in enumerate(responses):
            idx = int(r.get("index", i + 1))
            pub = point_from_bytes(self._bytes(r["publicKeyShare"]))
            resp_map[idx] = OPRFResponse(
                evaluated=point_from_bytes(self._bytes(r["evaluated"])),
                public_key=pub,
                dleq=DLEQProof(
                    c=int.from_bytes(self._bytes(r["c"]), "big"),
                    r=int.from_bytes(self._bytes(r["r"]), "big")),
            )
        server_pub = point_from_bytes(self._bytes(server_public_key))
        out = threshold_finalize(req, resp_map, server_public=server_pub)
        return {"output": _b64(int(out).to_bytes(32, "big"))}

    # --- proof surface: delegate to the groth16 *-toprf circuits ---

    def prove(self, wi, rng=None) -> dict:
        from ..operators import make_operator
        return make_operator(self.algorithm + "-toprf", "groth16",
                             device=self.device).prove(wi, rng)

    def verify(self, public_signals: list, proof_data: dict) -> bool:
        from ..operators import make_operator
        return make_operator(self.algorithm + "-toprf", "groth16",
                             device=self.device).verify(public_signals,
                                                        proof_data)

    @staticmethod
    def _bytes(v) -> bytes:
        return _unb64(v) if isinstance(v, str) else bytes(v)


def make_oprf_operator(algorithm: str = "chacha20", rng=None,
                       device=None) -> OPRFOperator:
    """Factory mirroring makeGnarkOPRFOperator (js/src/gnark/toprf.ts:17).
    device: where prove / verify run (default "cuda", as every entry point
    of the port)."""
    return OPRFOperator(algorithm, rng=rng, device=device)

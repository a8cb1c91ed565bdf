"""Phase-2 MPC ceremony for the Groth16 setup: contribute / beacon / verify.

The JAX package's ``groth16/ceremony.py`` (the snarkjs `zkey contribute` +
final random beacon shape): the per-point rerandomisation of the pk queries
runs as one device ladder per query (ops/ec.py:scale_points, on the GPU the
ladder kernel K3 of ops/msm_kernels.py, unreduced, one shared bit vector).

Model: `setup()` produces (pk0, vk0) from locally sampled toxic waste. Each
contribution k rerandomizes delta only (the standard phase-2 / "zkey" MPC):

    delta_k = d_k * delta_{k-1}          (d_k secret, discarded after use)

which transforms the key material as

    pk.delta_g1 *= d_k      pk.delta_g2 *= d_k      vk.delta_g2 *= d_k
    pk.h_query  *= 1/d_k    pk.c_query  *= 1/d_k

(h and c queries are the delta-divided elements; everything else in pk/vk is
delta-free). The proof system stays complete and sound at every step, and the
final delta's discrete log is unknown unless ALL contributors collude.

Each contribution publishes a `Contribution` record whose correctness is
pairing-checkable without any secret:

    e(d_g1, G2)            == e(G1, d_g2)           (same d in both groups)
    e(delta_g1_after, G2)  == e(delta_g1_before, d_g2)
    e(G1, delta_g2_after)  == e(d_g1, delta_g2_before)

and chains a SHA-256 transcript hash (prev_hash || serialized points), so a
log of contributions forms a hash-linked chain ending in a deterministic
random beacon (`apply_beacon`), exactly the snarkjs ceremony shape.

Scaled queries are verified separately (`verify_query_scaling`) with a random
linear combination: for random rho_i,
    e(sum rho_i * h_i_after, delta_g2_after) ==
    e(sum rho_i * h_i_before, delta_g2_before)
— both sides equal e(sum rho_i tau^i Z(tau) G1, G2) when the scaling is
honest; a forged query fails with probability 1 - 1/r.
"""
from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass

from ..curve import bn254_host as host
from ..fields.limb import Fp
from ..ops import ec
from ..ops.ec import JacPoint
from .setup import ProvingKey, VerifyingKey


def _ser_g1(pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return int(pt[0]).to_bytes(32, "big") + int(pt[1]).to_bytes(32, "big")


def _ser_g2(pt) -> bytes:
    if pt is None:
        return b"\x00" * 128
    return b"".join(int(c).to_bytes(32, "big") for c in (pt[0] + pt[1]))


@dataclass
class Contribution:
    """Public, pairing-checkable record of one delta rerandomization."""
    d_g1: tuple               # d * G1
    d_g2: tuple               # d * G2
    delta_g1_after: tuple
    delta_g2_after: tuple
    transcript: str           # SHA-256 chain hash (hex)
    kind: str = "contribution"   # or "beacon"
    beacon: str = ""             # beacon hex + iteration count, if kind=beacon

    def chain_hash(self, prev_hex: str) -> str:
        h = hashlib.sha256()
        h.update(bytes.fromhex(prev_hex) if prev_hex else b"")
        for b in (_ser_g1(self.d_g1), _ser_g2(self.d_g2),
                  _ser_g1(self.delta_g1_after), _ser_g2(self.delta_g2_after)):
            h.update(b)
        h.update(self.kind.encode())
        h.update(self.beacon.encode())
        return h.hexdigest()


def _apply_delta(pk: ProvingKey, vk: VerifyingKey, d: int,
                 prev_transcript: str, kind: str, beacon: str):
    """Shared update path for contribute() and apply_beacon()."""
    r = host.R
    d %= r
    if d in (0,):
        raise ValueError("contribution scalar must be nonzero mod r")
    d_inv = pow(d, -1, r)

    delta_g1_after = host.g1_mul(pk.delta_g1, d)
    delta_g2_after = host.g2_mul(pk.delta_g2, d)

    # device-side rerandomization of the delta-divided queries (one ladder
    # launch per query; ec.scale_points)
    h_query = ec.scale_points(ec.G1_OPS, pk.h_query, d_inv)
    c_query = ec.scale_points(ec.G1_OPS, pk.c_query, d_inv)

    pk2 = ProvingKey(
        n_public=pk.n_public, n_wires=pk.n_wires, domain_n=pk.domain_n,
        a_query=pk.a_query, b_g1_query=pk.b_g1_query,
        b_g2_query=pk.b_g2_query, c_query=c_query, h_query=h_query,
        delta_g1=delta_g1_after, beta_g1=pk.beta_g1, alpha_g1=pk.alpha_g1,
        beta_g2=pk.beta_g2, delta_g2=delta_g2_after, digest=pk.digest)
    vk2 = VerifyingKey(alpha_g1=vk.alpha_g1, beta_g2=vk.beta_g2,
                       gamma_g2=vk.gamma_g2, delta_g2=delta_g2_after,
                       ic=vk.ic, digest=vk.digest)

    con = Contribution(
        d_g1=host.g1_mul(host.G1_GEN, d), d_g2=host.g2_mul(host.G2_GEN, d),
        delta_g1_after=delta_g1_after, delta_g2_after=delta_g2_after,
        transcript="", kind=kind, beacon=beacon)
    con.transcript = con.chain_hash(prev_transcript)
    return pk2, vk2, con


def contribute(pk: ProvingKey, vk: VerifyingKey, entropy: bytes | None = None,
               prev_transcript: str = ""):
    """One MPC contribution. Returns (pk', vk', Contribution).

    The contribution scalar mixes caller entropy with fresh system randomness
    and the transcript so far, then is DISCARDED — only group elements leave
    this function (mirrors snarkjs zkey contribute semantics)."""
    seed = hashlib.sha256()
    seed.update(entropy or b"")
    seed.update(secrets.token_bytes(32))
    seed.update(prev_transcript.encode())
    d = (int.from_bytes(seed.digest() + hashlib.sha256(
        seed.digest()).digest(), "big") % (host.R - 1)) + 1
    return _apply_delta(pk, vk, d, prev_transcript, "contribution", "")


def apply_beacon(pk: ProvingKey, vk: VerifyingKey, beacon_hex: str,
                 n_iters: int = 10, prev_transcript: str = ""):
    """Final deterministic beacon: d = SHA-256^(2^n_iters)(beacon) mod r,
    publicly recomputable (the snarkjs `zkey beacon` analogue)."""
    cur = bytes.fromhex(beacon_hex)
    for _ in range(1 << n_iters):
        cur = hashlib.sha256(cur).digest()
    d = (int.from_bytes(cur + hashlib.sha256(cur).digest(), "big")
         % (host.R - 1)) + 1
    return _apply_delta(pk, vk, d, prev_transcript,
                        "beacon", f"{beacon_hex}:{n_iters}")


def verify_chain(delta_g1_0, delta_g2_0, contributions: list,
                 check_beacon_last: bool = False) -> bool:
    """Pairing-verify a contribution chain starting from the initial deltas
    (pk0.delta_g1, pk0.delta_g2). Each link must prove the SAME secret d was
    applied to G1, G2, and both running deltas; transcript hashes must chain."""
    g1, g2 = host.G1_GEN, host.G2_GEN
    prev_hex = ""
    d1, d2 = delta_g1_0, delta_g2_0
    for i, con in enumerate(contributions):
        if con.chain_hash(prev_hex) != con.transcript:
            return False
        # Untrusted points must be non-identity (a d=0 / delta=O record would
        # vacuously satisfy the pairing checks below and drive delta to the
        # point at infinity — a soundness break), canonical, on-curve, and —
        # for G2, whose twist has a large cofactor — in the r-torsion
        # subgroup. Mirrors snarkjs's non-identity + curve checks on
        # contribution records.
        for p1 in (con.d_g1, con.delta_g1_after):
            if p1 is None or not host.g1_is_canonical(p1) \
                    or not host.g1_is_on_curve(p1):
                return False
        for p2 in (con.d_g2, con.delta_g2_after):
            if p2 is None or not host.g2_is_canonical(p2) \
                    or not host.g2_is_on_curve(p2) \
                    or not host.g2_in_subgroup(p2):
                return False
        # same-d binding + both delta updates, as three pairing equations
        checks = [
            (con.d_g1, g2, g1, con.d_g2),
            (con.delta_g1_after, g2, d1, con.d_g2),
            (con.d_g1, d2, g1, con.delta_g2_after),
        ]
        for a1, a2, b1, b2 in checks:
            lhs = host.multi_pairing([(a1, a2), (host.g1_neg(b1), b2)])
            if lhs != host.F12_ONE:
                return False
        if con.kind == "beacon":
            # Recompute d from the public beacon and check d_g1. The record
            # is untrusted: malformed hex/iteration fields must return False
            # (not raise), and n_iters is capped so an attacker-supplied
            # record can't make the verifier grind 2^64 hashes (DoS).
            try:
                bhex, n_iters_s = con.beacon.rsplit(":", 1)
                n_iters = int(n_iters_s)
                cur = bytes.fromhex(bhex)
            except (ValueError, AttributeError):
                return False
            if not (0 <= n_iters <= 40):
                return False
            for _ in range(1 << n_iters):
                cur = hashlib.sha256(cur).digest()
            d = (int.from_bytes(cur + hashlib.sha256(cur).digest(), "big")
                 % (host.R - 1)) + 1
            if host.g1_mul(g1, d) != con.d_g1:
                return False
        prev_hex = con.transcript
        d1, d2 = con.delta_g1_after, con.delta_g2_after
    if check_beacon_last and (not contributions or
                              contributions[-1].kind != "beacon"):
        return False
    return True


def verify_query_scaling(query_before, query_after, delta_g2_before,
                         delta_g2_after, n_points: int,
                         rng=None) -> bool:
    """Random-linear-combination check that query_after == (1/d) *
    query_before for the d relating the two deltas:
    e(sum rho_i q_i_after, delta_after) == e(sum rho_i q_i_before, delta_before).

    query_*: device JacPoint batches (pk.h_query / pk.c_query shapes); only
    their first n_points lanes are read back."""
    if rng is None:
        rng = lambda: secrets.randbelow(host.R)
    head = lambda q: JacPoint(*(a[:, :n_points] for a in q))
    before = ec.g1_jac_to_host_affine(Fp, head(query_before), host.P)
    after = ec.g1_jac_to_host_affine(Fp, head(query_after), host.P)
    rhos = [rng() for _ in range(n_points)]
    sb = sa = None
    for rho, pb, pa in zip(rhos, before, after):
        if pb is not None:
            sb = host.g1_add(sb, host.g1_mul(pb, rho))
        if pa is not None:
            sa = host.g1_add(sa, host.g1_mul(pa, rho))
    if sa is None or sb is None:
        return sa is None and sb is None
    out = host.multi_pairing([(sa, delta_g2_after),
                              (host.g1_neg(sb), delta_g2_before)])
    return out == host.F12_ONE

"""Groth16 verifier (host-side pairing check).

Check: e(A, B) == e(alpha, beta) * e(sum_i pub_i * IC_i, gamma) * e(C, delta)
Equivalently (one multi-pairing): e(-A, B) * e(alpha, beta) * e(L, gamma)
* e(C, delta) == 1.

Fills the role of the reference verifiers (gnark libverify's groth16.Verify,
snarkjs groth16.verify — SURVEY.md §3.2). Public inputs here are bit wires
(0/1) for the cipher circuits, so the IC combination is a plain point-add
accumulation; general scalars fall back to host scalar mults.
"""
from __future__ import annotations

from ..curve import bn254_host as host
from .prove import Proof
from .setup import VerifyingKey


def verify(vk: VerifyingKey, proof: Proof, public_inputs: list) -> bool:
    if len(public_inputs) != len(vk.ic) - 1:
        return False
    for pt in (proof.a, proof.c):
        # G1's cofactor is 1 on BN254, so on-curve + canonical => in-subgroup.
        if not (host.g1_is_canonical(pt) and host.g1_is_on_curve(pt)):
            return False
    # B is untrusted G2: the twist has a large cofactor, so require full
    # order-R subgroup membership (and canonical coords), matching gnark's
    # strict proof deserialization.
    if not (host.g2_is_canonical(proof.b) and host.g2_in_subgroup(proof.b)):
        return False

    acc = vk.ic[0]
    for val, pt in zip(public_inputs, vk.ic[1:]):
        v = int(val) % host.R
        if v == 0:
            continue
        if v == 1:
            acc = host.g1_add(acc, pt)
        else:
            acc = host.g1_add(acc, host.g1_mul(pt, v))

    out = host.multi_pairing([
        (host.g1_neg(proof.a), proof.b),
        (vk.alpha_g1, vk.beta_g2),
        (acc, vk.gamma_g2),
        (proof.c, vk.delta_g2),
    ])
    return out == host.F12_ONE

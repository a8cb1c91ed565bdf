"""BabyJubJub twisted-Edwards curve (over BN254 Fr) — host arithmetic.

Fills the role of the reference's gnark-crypto twistededwards usage for the
OPRF/TOPRF/DLEQ protocol layer (gnark/utils/{oprf,toprf,dleq}.go — behavior
studied, implemented fresh). Curve: a*x^2 + y^2 = 1 + d*x^2*y^2 over Fq where
Fq = BN254 scalar field; a = 168700, d = 168696; cofactor 8; prime subgroup
order l. Points are affine (x, y) tuples; identity = (0, 1).
"""
from __future__ import annotations

Q = 21888242871839275222246405745257275088548364400416034343698204186575808495617
A = 168700
D = 168696
# prime order of the large subgroup (curve order = 8 * L_ORDER)
L_ORDER = 2736030358979909402780800718157159386076813972158567259200215660948447373041
COFACTOR = 8

# Standard Base8 point (generator of the prime-order subgroup)
BASE = (5299619240641551281634865583518297030282874472190772894086521144482721001553,
        16950150798460657717958625567821834550301663161624707787222815936182638968203)

IDENTITY = (0, 1)


def add(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    dxy = D * x1 * x2 % Q * y1 * y2 % Q
    x3 = (x1 * y2 + y1 * x2) * pow(1 + dxy, -1, Q) % Q
    y3 = (y1 * y2 - A * x1 * x2) * pow(1 - dxy, -1, Q) % Q
    return (x3, y3)


def neg(p):
    return ((-p[0]) % Q, p[1])


def mul(p, k: int):
    k %= L_ORDER * COFACTOR
    result = IDENTITY
    addend = p
    while k:
        if k & 1:
            result = add(result, addend)
        addend = add(addend, addend)
        k >>= 1
    return result


def is_on_curve(p) -> bool:
    x, y = p
    return (A * x * x + y * y) % Q == (1 + D * x * x % Q * y * y) % Q


def in_subgroup(p) -> bool:
    """Prime-subgroup membership: [l]P == identity (and not the identity of a
    small-order component: [8]P != identity unless P is identity)."""
    return is_on_curve(p) and mul(p, L_ORDER) == IDENTITY


def clear_cofactor(p):
    return mul(p, COFACTOR)


assert is_on_curve(BASE)
assert in_subgroup(BASE)

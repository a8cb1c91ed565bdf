"""Pure-int M31 / CM31 / QM31 arithmetic matching stwo's tower.

Copied from the JAX package's ``stark/stwo_compat/field.py``; the
prover's vectors use ``stark/m31.py`` (the same tower).

  M31  = F_p, p = 2^31 - 1
  CM31 = M31[i] / (i^2 + 1)
  QM31 = CM31[u] / (u^2 - (2 + i))

QM31 values are 4-tuples (a0, a1, b0, b1) = (a0 + a1*i) + (b0 + b1*i)*u —
the same coordinate order as stwo's serialization. This module is the
scalar reference used by the stwo-compat verifier/prover replicas (3-query
scale, so python ints are fine; the prover's column work is on tensors).
"""
from __future__ import annotations

P = (1 << 31) - 1

ZERO = (0, 0, 0, 0)
ONE = (1, 0, 0, 0)


def m31(x: int) -> int:
    return x % P


def qm31(a0, a1=0, b0=0, b1=0):
    return (a0 % P, a1 % P, b0 % P, b1 % P)


def add(x, y):
    return tuple((a + b) % P for a, b in zip(x, y))


def sub(x, y):
    return tuple((a - b) % P for a, b in zip(x, y))


def neg(x):
    return tuple((-a) % P for a in x)


def _cm_mul(a, b, c, d):
    """(a+bi)(c+di)"""
    return ((a * c - b * d) % P, (a * d + b * c) % P)


def mul(x, y):
    """QM31 multiply: (a + bu)(c + du) = ac + (2+i)bd + (ad + bc)u."""
    a0, a1, b0, b1 = x
    c0, c1, d0, d1 = y
    ac = _cm_mul(a0, a1, c0, c1)
    bd = _cm_mul(b0, b1, d0, d1)
    r = _cm_mul(2, 1, *bd)                      # (2+i)*bd
    ad = _cm_mul(a0, a1, d0, d1)
    bc = _cm_mul(b0, b1, c0, c1)
    return ((ac[0] + r[0]) % P, (ac[1] + r[1]) % P,
            (ad[0] + bc[0]) % P, (ad[1] + bc[1]) % P)


def mul_m31(x, s: int):
    return tuple((a * s) % P for a in x)


def conj(x):
    """Complex conjugate over the u-extension: a + bu -> a - bu."""
    a0, a1, b0, b1 = x
    return (a0, a1, (-b0) % P, (-b1) % P)


def _m31_inv(a: int) -> int:
    return pow(a, P - 2, P)


def _cm_inv(a, b):
    d = _m31_inv((a * a + b * b) % P)
    return ((a * d) % P, (-b * d) % P)


def inv(x):
    """QM31 inverse via the CM31 norm: (a+bu)^-1 = (a-bu)/(a^2-(2+i)b^2)."""
    a0, a1, b0, b1 = x
    a2 = _cm_mul(a0, a1, a0, a1)
    b2 = _cm_mul(b0, b1, b0, b1)
    tb2 = _cm_mul(2, 1, *b2)
    n = ((a2[0] - tb2[0]) % P, (a2[1] - tb2[1]) % P)
    ni = _cm_inv(*n)
    na = _cm_mul(a0, a1, *ni)
    nb = _cm_mul((-b0) % P, (-b1) % P, *ni)
    return (na[0], na[1], nb[0], nb[1])


def div(x, y):
    return mul(x, inv(y))


def pow_(x, e: int):
    r = ONE
    while e:
        if e & 1:
            r = mul(r, x)
        x = mul(x, x)
        e >>= 1
    return r

"""Mersenne-31 field arithmetic (M31, CM31, QM31) on PyTorch tensors.

Ported from the JAX package's ``stark/m31.py``. Values are held in int64,
canonical in [0, p): a product of two is < 2^62, so one fold
``(x & p) + (x >> 31)`` and a conditional subtract reduce it. (The
reference splits into 16-bit halves because the TPU has no 64-bit
multiply.) The outputs are the reference's values.

  M31:  p = 2^31 - 1
  CM31: M31[i] / (i^2 + 1)           (elements = (a, b) tuples)
  QM31: CM31[u] / (u^2 - (2 + i))    (elements = ((a, b), (c, d)))

All functions are elementwise over int64 tensors of any shape; an int
operand is broadcast.
"""
from __future__ import annotations

import torch

P31 = (1 << 31) - 1


def m31_reduce(x):
    """x in [0, 2^62] (any product of two canonical values) -> [0, p)."""
    r = (x & P31) + (x >> 31)
    return torch.where(r >= P31, r - P31, r)


def m31_add(a, b):
    r = a + b
    return torch.where(r >= P31, r - P31, r)


def m31_sub(a, b):
    r = a - b
    return torch.where(r < 0, r + P31, r)


def m31_neg(a):
    return torch.where(a == 0, a, P31 - a)


def m31_mul(a, b):
    return m31_reduce(a * b)


def m31_pow(a, e: int):
    result = torch.ones_like(a)
    for bit in bin(e)[2:]:
        result = m31_mul(result, result)
        if bit == "1":
            result = m31_mul(result, a)
    return result


def m31_inv(a):
    return m31_pow(a, P31 - 2)


# ---------------- CM31 = M31[i]/(i^2+1) ----------------

def cm31_add(a, b):
    return (m31_add(a[0], b[0]), m31_add(a[1], b[1]))


def cm31_sub(a, b):
    return (m31_sub(a[0], b[0]), m31_sub(a[1], b[1]))


def cm31_neg(a):
    return (m31_neg(a[0]), m31_neg(a[1]))


def cm31_mul(a, b):
    t0 = m31_mul(a[0], b[0])
    t1 = m31_mul(a[1], b[1])
    t2 = m31_mul(m31_add(a[0], a[1]), m31_add(b[0], b[1]))
    return (m31_sub(t0, t1), m31_sub(m31_sub(t2, t0), t1))


def cm31_inv(a):
    d = m31_inv(m31_add(m31_mul(a[0], a[0]), m31_mul(a[1], a[1])))
    return (m31_mul(a[0], d), m31_mul(m31_neg(a[1]), d))


# ---------------- QM31 = CM31[u]/(u^2 - (2+i)) ----------------

def _mul_2pi(a):
    """Multiply a CM31 element by (2 + i)."""
    two_a = cm31_add(a, a)
    ia = (m31_neg(a[1]), a[0])
    return cm31_add(two_a, ia)


def qm31_add(a, b):
    return (cm31_add(a[0], b[0]), cm31_add(a[1], b[1]))


def qm31_sub(a, b):
    return (cm31_sub(a[0], b[0]), cm31_sub(a[1], b[1]))


def qm31_mul(a, b):
    t0 = cm31_mul(a[0], b[0])
    t1 = cm31_mul(a[1], b[1])
    t2 = cm31_mul(cm31_add(a[0], a[1]), cm31_add(b[0], b[1]))
    c0 = cm31_add(t0, _mul_2pi(t1))
    c1 = cm31_sub(cm31_sub(t2, t0), t1)
    return (c0, c1)


def qm31_inv(a):
    """(a0 + a1 u)^-1 = (a0 - a1 u) / (a0^2 - (2+i) a1^2)."""
    d = cm31_sub(cm31_mul(a[0], a[0]), _mul_2pi(cm31_mul(a[1], a[1])))
    di = cm31_inv(d)
    return (cm31_mul(a[0], di), cm31_mul(cm31_neg(a[1]), di))

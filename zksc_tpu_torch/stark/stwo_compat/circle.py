"""M31 circle group geometry matching stwo's conventions (stwo @ f117d48).

Copied from the JAX package's ``stark/stwo_compat/circle.py``.

Points live on x^2 + y^2 = 1 over M31 (group order 2^31). stwo addresses
points by CirclePointIndex (multiples of the full-order generator) and
stores evaluations of a CanonicCoset circle domain in bit-reversed order,
which places each point adjacent to its fold sibling.

Conventions (validated against reference-proof ground truth — NOTES.md):
  M31_CIRCLE_GEN        = (2, 1268011823), order 2^31
  Coset(log_size s)     : initial + k*step, step = (2^(31-s)) * GEN
  CanonicCoset(s)       : initial_index = 2^(31-s-1), step 2^(31-s)
  .circle_domain()      : half_coset = Coset(initial 2^(31-s-1), step
                          2^(31-s+1)? -- see CircleDomain below) of size
                          2^(s-1), domain = half_coset u (-half_coset)
  CircleDomain.at(i)    : i < N/2 -> half_coset.at(i); else
                          conj(half_coset.at(i - N/2))
  storage order         : bit_reverse(natural index) over log_size bits
"""
from __future__ import annotations

from .field import P

GEN = (2, 1268011823)          # order-2^31 generator of the circle group
LOG_ORDER = 31


def p_add(a, b):
    ax, ay = a
    bx, by = b
    return ((ax * bx - ay * by) % P, (ax * by + ay * bx) % P)


def p_neg(a):
    return (a[0], (-a[1]) % P)


def p_double(a):
    return p_add(a, a)


def p_mul(a, k: int):
    r = (1, 0)
    while k:
        if k & 1:
            r = p_add(r, a)
        a = p_double(a)
        k >>= 1
    return r


def point_at_index(idx: int):
    """CirclePointIndex -> point (idx in multiples of GEN, mod 2^31)."""
    return p_mul(GEN, idx % (1 << LOG_ORDER))


def bit_reverse(i: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (i & 1)
        i >>= 1
    return r


class Coset:
    def __init__(self, initial_index: int, log_size: int):
        self.initial_index = initial_index % (1 << LOG_ORDER)
        self.log_size = log_size
        self.step_index = (1 << (LOG_ORDER - log_size)) % (1 << LOG_ORDER)

    def index_at(self, i: int) -> int:
        return (self.initial_index + i * self.step_index) % (1 << LOG_ORDER)

    def at(self, i: int):
        return point_at_index(self.index_at(i))


class CircleDomain:
    """half_coset u conjugate(half_coset); size 2^(half.log_size + 1)."""

    def __init__(self, half_coset: Coset):
        self.half_coset = half_coset
        self.log_size = half_coset.log_size + 1

    def index_at(self, i: int) -> int:
        h = 1 << self.half_coset.log_size
        if i < h:
            return self.half_coset.index_at(i)
        return (-self.half_coset.index_at(i - h)) % (1 << LOG_ORDER)

    def at(self, i: int):
        return point_at_index(self.index_at(i))

    def at_stored(self, i: int):
        """Point at bit-reversed storage position i."""
        return self.at(bit_reverse(i, self.log_size))


class CanonicCoset:
    def __init__(self, log_size: int):
        self.log_size = log_size
        self.coset = Coset(1 << (LOG_ORDER - log_size - 1), log_size)

    def circle_domain(self) -> CircleDomain:
        # half coset of size 2^(log_size-1) stepping by double the canonic
        # step, starting at the canonic initial index
        half = Coset(1 << (LOG_ORDER - self.log_size - 1),
                     self.log_size - 1)
        half.step_index = (1 << (LOG_ORDER - self.log_size + 1)) \
            % (1 << LOG_ORDER)
        return CircleDomain(half)


class LineDomain:
    """x-projections of a coset (used by FRI inner layers)."""

    def __init__(self, coset: Coset):
        self.coset = coset
        self.log_size = coset.log_size

    def at(self, i: int) -> int:
        return self.coset.at(i)[0]

    def at_stored(self, i: int) -> int:
        return self.at(bit_reverse(i, self.log_size))

    def double(self) -> "LineDomain":
        c = Coset(self.coset.initial_index * 2, self.coset.log_size - 1)
        c.step_index = (self.coset.step_index * 2) % (1 << LOG_ORDER)
        return LineDomain(c)

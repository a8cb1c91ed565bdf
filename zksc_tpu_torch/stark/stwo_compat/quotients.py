"""stwo's OODS quotient combination — bit-exact replica.

Copied from the JAX package's ``stark/stwo_compat/quotients.py``.

All committed columns are sampled at the single OODS point P; the verifier
(and prover) combine them into one secure "FRI answer" column:

  Q(x,y) = -2u * [ sum_j gamma^j * (c*f_j(x,y) - (a_j*y + b_j)) ]
                 / pair_vanishing(P, conj(P), (x,y))

  a_j = conj(v_j) - v_j
  c   = conj(P).y - P.y
  b_j = v_j*c - a_j*P.y
  pair_vanishing(P,Pc,(x,y)) = (P.y-Pc.y)*x + (Pc.x-P.x)*y
                               + (P.x*Pc.y - Pc.x*P.y)

with gamma the draw following the sampled-values mix, j in column order
(tree-major), alpha starting at gamma^0, and u the QM31 unit (0,0,1,0).
The global factor (-2u) was established against reference ground truth
(NOTES.md); it folds the reference's internal normalization.
"""
from __future__ import annotations

from . import field as F


def oods_point(t):
    """Circle point from the channel draw t: ((1-t^2)/(1+t^2), 2t/(1+t^2))."""
    t2 = F.mul(t, t)
    d = F.inv(F.add(F.ONE, t2))
    return (F.mul(F.sub(F.ONE, t2), d), F.mul(F.add(t, t), d))


class QuotientCombiner:
    """Precomputes per-column line coefficients for a fixed P and gamma."""

    def __init__(self, P, gamma, sampled_values):
        self.Px, self.Py = P
        self.Pcx, self.Pcy = F.conj(self.Px), F.conj(self.Py)
        self.c = F.sub(self.Pcy, self.Py)
        self.coeffs = []
        alpha = F.ONE
        for v in sampled_values:
            a = F.sub(F.conj(v), v)
            b = F.sub(F.mul(v, self.c), F.mul(a, self.Py))
            self.coeffs.append((F.mul(alpha, a), F.mul(alpha, b),
                                F.mul(alpha, self.c)))
            alpha = F.mul(alpha, gamma)
        self.minus_2u = (0, 0, F.P - 2, 0)

    def at(self, point, column_values):
        """Quotient at a domain point given all column values there."""
        x, y = point
        num = F.ZERO
        for (a, b, c), fv in zip(self.coeffs, column_values):
            num = F.add(num, F.sub(F.mul_m31(c, int(fv)),
                                   F.add(F.mul_m31(a, y), b)))
        den = F.add(
            F.add(F.mul_m31(F.sub(self.Py, self.Pcy), x),
                  F.mul_m31(F.sub(self.Pcx, self.Px), y)),
            F.sub(F.mul(self.Px, self.Pcy), F.mul(self.Pcx, self.Py)))
        return F.mul(F.mul(num, F.inv(den)), self.minus_2u)

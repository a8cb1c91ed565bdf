"""stwo FRI — bit-exact replica (folds, domains, layer trees).

Copied from the JAX package's ``stark/stwo_compat/fri.py``.

Validated fold formulas (doubling variant, NOTES.md):
  circle -> line : g[k] = (v0+v1) + alpha*(v0-v1)/y,  y of point at
                   stored index 2k of the circle domain
  line fold      : g[k] = (v0+v1) + alpha*(v0-v1)/x,  x of the line
                   domain at stored index 2k; domain doubles each layer
  last layer     : constant-poly coeffs (log_last_layer_degree_bound=0)
                   must equal every remaining folded value

Layer trees commit one QM31 column: leaf(pos) = blake2s(4 LE u32 coords);
decommit/verify identical to the lifted Merkle scheme.
"""
from __future__ import annotations

import struct

from . import field as F
from .circle import LOG_ORDER, bit_reverse, point_at_index
from .merkle import _h, verify as merkle_verify


def qm31_leaf(v) -> bytes:
    return _h(struct.pack("<4I", *[int(x) & 0xFFFFFFFF for x in v]))


class LineDomainIter:
    """x-projections of a coset; doubles per fold layer."""

    def __init__(self, initial_index: int, step_index: int, log_size: int):
        self.init = initial_index % (1 << LOG_ORDER)
        self.step = step_index % (1 << LOG_ORDER)
        self.log = log_size

    def x_at_stored(self, i: int) -> int:
        idx = (self.init + bit_reverse(i, self.log) * self.step) \
            % (1 << LOG_ORDER)
        return point_at_index(idx)[0]

    def double(self) -> "LineDomainIter":
        return LineDomainIter(self.init * 2, self.step * 2, self.log - 1)


def fold_circle_pair(v0, v1, y: int, alpha):
    s = F.add(v0, v1)
    d = F.mul_m31(F.sub(v0, v1), pow(y, F.P - 2, F.P))
    return F.add(s, F.mul(alpha, d))


def fold_line_pair(v0, v1, x: int, alpha):
    s = F.add(v0, v1)
    d = F.mul_m31(F.sub(v0, v1), pow(x, F.P - 2, F.P))
    return F.add(s, F.mul(alpha, d))


def verify_fri(proof, circle_domain, positions, first_values: dict,
               alphas) -> bool:
    """Verify the full FRI decommitment chain.

    proof: StwoStreamProof (first_layer / inner_layers / last coeffs).
    circle_domain: commitment-domain CircleDomain (log = log_size+blowup).
    positions: sorted stored query positions.
    first_values: {pos: QM31} verifier-computed quotients at positions.
    alphas: fold challenges (first + one per inner layer).
    """
    # --- first (circle) layer ---
    vals = dict(first_values)
    wit = [tuple(w) for w in proof.first_layer.fri_witness]
    need = []
    for pos in positions:
        sib = pos ^ 1
        if sib not in vals:
            need.append(sib)
    for s in sorted(need):
        if not wit:
            return False
        vals[s] = wit.pop(0)
    if wit:
        return False
    leaves = {pos: qm31_leaf(v) for pos, v in vals.items()}
    if not merkle_verify(leaves, proof.first_layer.hash_witness,
                         circle_domain.log_size,
                         proof.first_layer.commitment):
        return False
    alpha = alphas[0]
    folded = {}
    for pos in sorted(vals):
        k = pos // 2
        if k in folded:
            continue
        y = circle_domain.at_stored(2 * k)[1]
        folded[k] = fold_circle_pair(vals[2 * k], vals[2 * k + 1], y, alpha)

    # --- inner (line) layers ---
    half = circle_domain.half_coset
    ld = LineDomainIter(half.initial_index, half.step_index, half.log_size)
    for li, layer in enumerate(proof.inner_layers):
        vals = {k: v for k, v in folded.items()}
        wit = [tuple(w) for w in layer.fri_witness]
        need = sorted(p ^ 1 for p in vals if (p ^ 1) not in vals)
        for s in need:
            if not wit:
                return False
            vals[s] = wit.pop(0)
        if wit:
            return False
        leaves = {pos: qm31_leaf(v) for pos, v in vals.items()}
        if not merkle_verify(leaves, layer.hash_witness, ld.log,
                             layer.commitment):
            return False
        alpha = alphas[1 + li]
        folded = {}
        for pos in sorted(vals):
            k = pos // 2
            if k in folded:
                continue
            x = ld.x_at_stored(2 * k)
            folded[k] = fold_line_pair(vals[2 * k], vals[2 * k + 1], x,
                                       alpha)
        ld = ld.double()

    # --- last layer (constant poly) ---
    if proof.last_layer_log_size != 0 or len(proof.last_layer_coeffs) != 1:
        return False
    last = tuple(proof.last_layer_coeffs[0])
    return all(v == last for v in folded.values())

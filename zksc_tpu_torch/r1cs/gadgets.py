"""General-purpose R1CS gadget library.

The reference ships a standalone helper-gadget file for its circom circuits
(circom/circuits/helper_functions.circom:8-251: IndexSelector — a mux built
from IsEqual selectors — and Typecast between word widths; studied for
behavior, re-designed for this builder's dual R1CS/witness api). Gadgets are
plain functions over the `api` object, so the same code records constraints
(R1CSBuilder) and computes witness values (WitnessBuilder).
"""
from __future__ import annotations

from .builder import FIELD_R


def is_zero(api, a):
    """z = 1 if a == 0 else 0, sound for any field element.

    Standard inverse-hint construction: allocate inv (a's inverse when one
    exists), constrain p = a*inv and a*(1-p) = 0. If a != 0 the second
    constraint forces p = 1; if a == 0 the first forces p = 0."""
    def inv_hint(av):
        return [[pow(int(x) % FIELD_R, -1, FIELD_R)
                 if int(x) % FIELD_R else 0 for x in av]]

    (inv,) = api.hint(inv_hint, [a], 1)
    p = api.mul(a, inv)
    z = api.sub(api.constant(1), p)
    api.mul_eq(a, z, api.constant(0))
    return z


def is_equal(api, a, b):
    """1 if a == b else 0."""
    return is_zero(api, api.sub(a, b))


def index_select(api, items: list, idx):
    """items[idx] as a constraint: per-item IsEqual selectors whose sum is
    constrained to 1 (so idx MUST name a valid entry), output the selector-
    weighted sum. Mirrors circom's IndexSelector (helper_functions.circom)."""
    sels = [is_equal(api, idx, api.constant(i)) for i in range(len(items))]
    api.assert_eq(api.add(*sels), api.constant(1))
    out = api.mul(sels[0], items[0])
    for s, it in zip(sels[1:], items[1:]):
        out = api.add(out, api.mul(s, it))
    return out


def typecast(api, words: list, in_width: int, out_width: int) -> list:
    """Repack words of in_width bits into words of out_width bits (LSB-first
    bit order throughout, matching to_bits/from_bits). Total bit count must
    tile the output width. Decomposition is constrained (booleanity +
    packing) by to_bits; repacking is a pure linear combination."""
    bits = []
    for w in words:
        bits.extend(api.to_bits(w, in_width))
    if len(bits) % out_width:
        raise ValueError(
            f"{len(words)}x{in_width} bits do not tile width {out_width}")
    return [api.from_bits(bits[i:i + out_width])
            for i in range(0, len(bits), out_width)]

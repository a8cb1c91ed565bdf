"""ChaCha20 stream AIR replica — constraint evaluation at a point.

Mirrors the reference evaluator exactly (column read order and constraint
emission order), operating on QM31 values — used for the verifier's OODS
composition check and the prover's composition polynomial:
  stwo/src/chacha/bitwise/constraints_stream.rs (ChaChaStreamEvalAtRow)

Column layout (33280 cols, all single-sample at offset 0):
  initial state bits (16 x 32, LSB-first), then per quarter-round op the
  result bits (+ carries for adds), final keystream adds, plaintext bits,
  public ciphertext bits. Constraint count 54784.

The accumulator follows stwo's PointEvaluationAccumulator: the running
sum is acc = acc * alpha + constraint, i.e. the FIRST emitted constraint
ends up with the HIGHEST alpha power.

The QM31 walk is copied from the JAX package's ``stark/stwo_compat/air.py``
(the verifier's OODS check). The prover does not walk values: ``layout()``
walks the AIR once with column indices and returns K7c's index groups
(``ops/stark_kernels.pack_groups``' form) and each constraint's emission
index, so the composition is ``stark_kernels.composition`` on the card and
``stark.prover._composition_plain`` on the CPU, with constraint k weighted
by alpha^(N_CONSTRAINTS - 1 - its emission index). stwo's constraints are
K7c's forms exactly: bool b(1 - b), add (R + 2C) - (A + B + Cin), xor
R + 2AB - (A + B), eq (KS + PT) - (2 KS PT + CT); no addx.
"""
from __future__ import annotations

import numpy as np

from . import field as F

N_COLS = 33280
N_CONSTRAINTS = 54784
STATE_SIZE = 16
# the row of the prover's values [N_COLS + 1, M] that holds zeros: the
# carry into bit 0 of an add
ZERO_ROW = N_COLS

_QR_IDX = [(0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
           (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14)]


class _QM31Ops:
    add = staticmethod(F.add)
    sub = staticmethod(F.sub)
    mul = staticmethod(F.mul)
    one = F.ONE
    zero = F.ZERO


class _Eval:
    """Walks columns in order, collecting constraint values."""

    def __init__(self, cols, ops):
        self.cols = cols
        self.ops = ops
        self.i = 0
        self.constraints = []

    def next_mask(self):
        v = self.cols[self.i]
        self.i += 1
        return v

    def con(self, v):
        self.constraints.append(v)

    def next_u32(self):
        o = self.ops
        bits = []
        for _ in range(32):
            b = self.next_mask()
            self.con(o.mul(b, o.sub(o.one, b)))          # boolean
            bits.append(b)
        return bits

    def add_u32(self, a, b):
        o = self.ops
        result = self.next_u32()
        carries = [self.next_mask() for _ in range(32)]
        for i in range(32):
            cin = o.zero if i == 0 else carries[i - 1]
            c = carries[i]
            self.con(o.mul(c, o.sub(o.one, c)))          # carry boolean
            # result + 2*carry - a - b - carry_in
            self.con(o.sub(o.sub(o.sub(o.add(result[i], o.add(c, c)),
                                       a[i]), b[i]), cin))
        return result

    def xor_rotl_u32(self, a, b, r):
        o = self.ops
        result = self.next_u32()
        for i in range(32):
            src = (i + 32 - r) % 32
            ab = o.mul(a[src], b[src])
            self.con(o.add(o.sub(o.sub(result[i], a[src]), b[src]),
                           o.add(ab, ab)))
        return result

    def xor_eq(self, a, b, ct):
        """keystream bit a xor plaintext bit b equals ciphertext bit ct."""
        o = self.ops
        ab = o.mul(a, b)
        computed = o.sub(o.add(a, b), o.add(ab, ab))
        self.con(o.sub(computed, ct))

    def quarter_round(self, v, a, b, c, d):
        v[a] = self.add_u32(v[a], v[b])
        v[d] = self.xor_rotl_u32(v[a], v[d], 16)
        v[c] = self.add_u32(v[c], v[d])
        v[b] = self.xor_rotl_u32(v[c], v[b], 12)
        v[a] = self.add_u32(v[a], v[b])
        v[d] = self.xor_rotl_u32(v[a], v[d], 8)
        v[c] = self.add_u32(v[c], v[d])
        v[b] = self.xor_rotl_u32(v[c], v[b], 7)


class _LayoutEval(_Eval):
    """The walk with column indices for values: records each constraint
    as (group, its fields' rows), in emission order."""

    def __init__(self, cols=None, ops=None):
        super().__init__(list(range(N_COLS)), None)

    def next_u32(self):
        bits = [self.next_mask() for _ in range(32)]
        for b in bits:
            self.con(("bool", (b,)))
        return bits

    def add_u32(self, a, b):
        result = self.next_u32()
        carries = [self.next_mask() for _ in range(32)]
        for i in range(32):
            cin = ZERO_ROW if i == 0 else carries[i - 1]
            self.con(("bool", (carries[i],)))
            self.con(("add", (a[i], b[i], result[i], carries[i], cin)))
        return result

    def xor_rotl_u32(self, a, b, r):
        result = self.next_u32()
        for i in range(32):
            src = (i + 32 - r) % 32
            self.con(("xor", (a[src], b[src], result[i])))
        return result

    def xor_eq(self, a, b, ct):
        self.con(("eq", (a, b, ct)))


def _walk(cols, ops, cls=_Eval):
    e = cls(cols, ops)
    initial = [e.next_u32() for _ in range(STATE_SIZE)]
    v = list(initial)
    for _ in range(10):
        for (a, b, c, d) in _QR_IDX:
            e.quarter_round(v, a, b, c, d)
    keystream = [e.add_u32(v[i], initial[i]) for i in range(STATE_SIZE)]
    plaintext = [e.next_u32() for _ in range(STATE_SIZE)]
    ciphertext = [e.next_u32() for _ in range(STATE_SIZE)]
    for i in range(STATE_SIZE):
        for bi in range(32):
            e.xor_eq(keystream[i][bi], plaintext[i][bi], ciphertext[i][bi])
    assert e.i == N_COLS, e.i
    assert len(e.constraints) == N_CONSTRAINTS, len(e.constraints)
    return e.constraints


def evaluate_constraints(cols):
    """cols: 33280 QM31 values (the per-column samples at one point).
    Returns the list of 54784 constraint values in emission order."""
    return _walk(cols, _QM31Ops())


def accumulate(constraints, alpha):
    """stwo PointEvaluationAccumulator: acc = acc*alpha + c, in order."""
    acc = F.ZERO
    for c in constraints:
        acc = F.add(F.mul(acc, alpha), c)
    return acc


# K7c's groups and their fields, in its order (ops/stark_kernels.GROUP_FIELDS)
_FIELDS = {"bool": (None,), "add": ("A", "B", "R", "C", "Cin"),
           "addx": ("U", "W", "B", "R", "C", "Cin"), "xor": ("A", "B", "R"),
           "eq": ("KS", "PT", "CT")}
_LAYOUT = {}


def layout():
    """(groups, order), cached: K7c's index groups of this AIR (rows of the
    values [N_COLS + 1, M], ZERO_ROW the zeros; "addx" empty) and order, int64
    [N_CONSTRAINTS]: the emission index of each constraint in K7c's order
    (bool, add, addx, xor, eq)."""
    if "v" not in _LAYOUT:
        cons = _walk(None, None, cls=_LayoutEval)
        groups, order = {}, []
        for name, fields in _FIELDS.items():
            mine = [(k, rows) for k, (g, rows) in enumerate(cons) if g == name]
            order += [k for k, _ in mine]
            if fields == (None,):
                groups[name] = [rows[0] for _, rows in mine]
            else:
                groups[name] = {f: [rows[i] for _, rows in mine]
                                for i, f in enumerate(fields)}
        _LAYOUT["v"] = (groups, np.asarray(order, dtype=np.int64))
    return _LAYOUT["v"]

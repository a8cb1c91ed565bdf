"""R1CS constraint-system builder + witness generator.

A gnark-flavored circuit frontend (reference behavior: gnark circuits define
constraints through an api object, gnark/circuits/chachaV3/round.go — studied
for semantics, re-designed here): circuit definitions are plain Python
functions over an `api`, executed twice with identical allocation order:

  - R1CSBuilder: records sparse A/B/C constraint rows (dict linear combos).
  - WitnessBuilder: computes concrete wire values, vectorized over a batch of
    proofs (numpy object arrays holding exact field integers).

Wire layout (Groth16 convention): wire 0 = constant 1, then public inputs,
then private inputs, then internal wires.

Constraint semantics: <A_i, z> * <B_i, z> = <C_i, z> (mod r).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from ..fields.limb import BN254_R as FIELD_R


class Var:
    """A linear combination of wires: {wire_index: coeff}. Immutable-ish."""
    __slots__ = ("lc",)

    def __init__(self, lc: dict):
        self.lc = lc


def _lc_add(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        nv = (out.get(k, 0) + v) % FIELD_R
        if nv:
            out[k] = nv
        else:
            out.pop(k, None)
    return out


def _lc_scale(a: dict, s: int) -> dict:
    s %= FIELD_R
    if s == 0:
        return {}
    return {k: (v * s) % FIELD_R for k, v in a.items()}


@dataclass
class ConstraintSystem:
    n_public: int = 0            # number of public input wires (excl. wire 0)
    n_wires: int = 1             # includes wire 0 (constant 1)
    constraints: list = field(default_factory=list)   # (lcA, lcB, lcC)

    @property
    def n_constraints(self) -> int:
        return len(self.constraints)

    def digest(self) -> str:
        """Stable hash of the constraint system, for artifact pinning
        (mirrors the reference's SHA-256 circuit-hash pinning,
        gnark/keygen/keygen.go:144-160)."""
        h = hashlib.sha256()
        h.update(f"{self.n_public}|{self.n_wires}|{len(self.constraints)}".encode())
        for (a, b, c) in self.constraints:
            for lc in (a, b, c):
                for k in sorted(lc):
                    h.update(f"{k}:{lc[k]};".encode())
                h.update(b"|")
        return h.hexdigest()


class R1CSBuilder:
    """Records constraints; variables are symbolic linear combinations."""
    is_witness = False

    def __init__(self):
        self.cs = ConstraintSystem()
        self._one = Var({0: 1})

    # -- allocation --
    def _new_wire(self) -> int:
        idx = self.cs.n_wires
        self.cs.n_wires += 1
        return idx

    def alloc_input(self) -> Var:
        return Var({self._new_wire(): 1})

    # -- linear ops (free) --
    def constant(self, c: int) -> Var:
        return Var({0: c % FIELD_R} if c % FIELD_R else {})

    def add(self, *vs) -> Var:
        out = {}
        for v in vs:
            out = _lc_add(out, v.lc)
        return Var(out)

    def sub(self, a: Var, b: Var) -> Var:
        return Var(_lc_add(a.lc, _lc_scale(b.lc, FIELD_R - 1)))

    def mul_const(self, a: Var, k: int) -> Var:
        return Var(_lc_scale(a.lc, k))

    # -- constraints --
    def mul(self, a: Var, b: Var) -> Var:
        w = self._new_wire()
        self.cs.constraints.append((a.lc, b.lc, {w: 1}))
        return Var({w: 1})

    def xor(self, a: Var, b: Var) -> Var:
        """Bit xor (inputs assumed boolean): c = a + b - 2ab via (2a)*b = a+b-c."""
        w = self._new_wire()
        c = Var({w: 1})
        lhs = _lc_scale(a.lc, 2)
        rhs = _lc_add(_lc_add(a.lc, b.lc), _lc_scale({w: 1}, FIELD_R - 1))
        self.cs.constraints.append((lhs, b.lc, rhs))
        return c

    def xor_constrain(self, a: Var, b: Var, out: Var):
        """Constrain out == a xor b without a new wire: (2a)*b = a+b-out."""
        lhs = _lc_scale(a.lc, 2)
        rhs = _lc_add(_lc_add(a.lc, b.lc), _lc_scale(out.lc, FIELD_R - 1))
        self.cs.constraints.append((lhs, b.lc, rhs))

    def mul_eq(self, a: Var, b: Var, c: Var):
        """Constrain a * b == c (no new wire)."""
        self.cs.constraints.append((a.lc, b.lc, c.lc))

    def assert_bool(self, a: Var):
        self.cs.constraints.append((a.lc, _lc_add(a.lc, {0: FIELD_R - 1}), {}))

    def assert_eq(self, a: Var, b: Var):
        diff = self.sub(a, b)
        self.cs.constraints.append((diff.lc, {0: 1}, {}))

    def to_bits(self, a: Var, n: int, hint=None) -> list:
        """Decompose a into n bits (LSB first): booleanity + packing constraint."""
        bits = []
        for _ in range(n):
            w = self._new_wire()
            bits.append(Var({w: 1}))
        for b in bits:
            self.assert_bool(b)
        packed = {}
        for i, b in enumerate(bits):
            packed = _lc_add(packed, _lc_scale(b.lc, 1 << i))
        self.cs.constraints.append((_lc_add(a.lc, _lc_scale(packed, FIELD_R - 1)),
                                    {0: 1}, {}))
        return bits

    def from_bits(self, bits: list) -> Var:
        packed = {}
        for i, b in enumerate(bits):
            packed = _lc_add(packed, _lc_scale(b.lc, 1 << i))
        return Var(packed)

    def hint(self, fn, inputs: list, n_out: int) -> list:
        """Allocate n_out unconstrained wires whose values the witness builder
        computes via fn(values...). The circuit MUST constrain them."""
        return [Var({self._new_wire(): 1}) for _ in range(n_out)]


class WitnessBuilder:
    """Computes wire values; variables are numpy object arrays [batch]."""
    is_witness = True

    def __init__(self, batch: int):
        self.batch = batch
        one = np.full(batch, 1, dtype=object)
        self.values = [one]           # wire 0

    def _push(self, arr) -> int:
        self.values.append(arr % FIELD_R)
        return len(self.values) - 1

    def alloc_input(self, values=None):
        assert values is not None, "witness inputs need values"
        arr = np.asarray(values, dtype=object) % FIELD_R
        assert arr.shape == (self.batch,)
        self._push(arr)
        return arr

    def constant(self, c: int):
        return np.full(self.batch, c % FIELD_R, dtype=object)

    def add(self, *vs):
        out = vs[0].copy()
        for v in vs[1:]:
            out = out + v
        return out % FIELD_R

    def sub(self, a, b):
        return (a - b) % FIELD_R

    def mul_const(self, a, k: int):
        return (a * (k % FIELD_R)) % FIELD_R

    def mul(self, a, b):
        out = (a * b) % FIELD_R
        self._push(out)
        return out

    def xor(self, a, b):
        out = (a + b - 2 * a * b) % FIELD_R
        self._push(out)
        return out

    def xor_constrain(self, a, b, out):
        pass

    def mul_eq(self, a, b, c):
        pass

    def assert_bool(self, a):
        pass

    def assert_eq(self, a, b):
        pass

    def to_bits(self, a, n: int, hint=None):
        bits = []
        for i in range(n):
            arr = np.asarray([(int(x) >> i) & 1 for x in a], dtype=object)
            self._push(arr)
            bits.append(arr)
        return bits

    def from_bits(self, bits: list):
        out = self.constant(0)
        for i, b in enumerate(bits):
            out = out + (b * (1 << i))
        return out % FIELD_R

    def hint(self, fn, inputs: list, n_out: int):
        outs = fn(*inputs)   # list of n_out arrays
        assert len(outs) == n_out
        res = []
        for o in outs:
            arr = np.asarray(o, dtype=object) % FIELD_R
            self._push(arr)
            res.append(arr)
        return res


def compile_circuit(define_fn, public_layout: list, private_layout: list) -> ConstraintSystem:
    """Build the R1CS. Layouts are [(name, count), ...]; define_fn(api, vars)
    with vars = {name: [Var]*count}."""
    api = R1CSBuilder()
    cs = api.cs
    vars_ = {}
    for name, count in public_layout:
        vars_[name] = [api.alloc_input() for _ in range(count)]
    cs.n_public = cs.n_wires - 1
    for name, count in private_layout:
        vars_[name] = [api.alloc_input() for _ in range(count)]
    define_fn(api, vars_)
    return cs


def generate_witness(define_fn, public_layout, private_layout,
                     public_values: dict, private_values: dict, batch: int) -> np.ndarray:
    """Run the circuit in witness mode. Values dicts: name -> array [count, batch]
    (ints). Returns the full witness matrix [n_wires, batch].

    Fast path: the circuit is compiled once to a flat instruction tape and
    executed natively (r1cs/tape.py + native/tape_exec.cc) when interval
    analysis proves uint64 arithmetic suffices and all inputs are boolean —
    true for the cipher circuits, where the Python builder costs ~0.5 s per
    proof. Anything else (big-field TOPRF gadgets, missing toolchain) falls
    back to the exact Python evaluation below."""
    from .tape import build_tape
    tape = build_tape(define_fn, public_layout, private_layout)
    if tape is not None:
        rows = []
        ok = True
        for name, count in list(public_layout) + list(private_layout):
            vals = (public_values if name in public_values
                    else private_values)[name]
            assert len(vals) == count, f"{name}: {len(vals)} != {count}"
            for i in range(count):
                row = [int(v) for v in vals[i]]
                if any(v < 0 or v > 1 for v in row):
                    ok = False
                    break
                rows.append(row)
            if not ok:
                break
        if ok:
            try:
                inputs = np.asarray(rows, dtype=np.uint64)
                return tape.execute(inputs)
            except RuntimeError:
                pass   # native library unavailable -> Python fallback

    api = WitnessBuilder(batch)
    vars_ = {}
    for name, count in public_layout:
        vals = public_values[name]
        assert len(vals) == count, f"{name}: {len(vals)} != {count}"
        vars_[name] = [api.alloc_input(vals[i]) for i in range(count)]
    for name, count in private_layout:
        vals = private_values[name]
        assert len(vals) == count
        vars_[name] = [api.alloc_input(vals[i]) for i in range(count)]
    define_fn(api, vars_)
    return np.stack(api.values)


def check_witness(cs: ConstraintSystem, witness: np.ndarray) -> bool:
    """Host-side satisfaction check (oracle for tests)."""
    batch = witness.shape[1]
    for (a, b, c) in cs.constraints:
        for j in range(batch):
            av = sum(int(witness[k, j]) * v for k, v in a.items()) % FIELD_R
            bv = sum(int(witness[k, j]) * v for k, v in b.items()) % FIELD_R
            cv = sum(int(witness[k, j]) * v for k, v in c.items()) % FIELD_R
            if av * bv % FIELD_R != cv:
                return False
    return True

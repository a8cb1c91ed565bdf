"""Witness tape: compile a circuit's witness computation to a flat
instruction list, executed natively (zksc_tpu_torch/native/tape_exec.cc).

The per-proof witness build was ~0.5 s of Python (one interpreted call per
gate, ~46K gates for the chacha chunk); the reference keeps this path native
(gnark Go assignments, circom WASM calculator — SURVEY.md §2.5 item 3). Here
the circuit's define() runs ONCE against a TapeBuilder that records a flat
tape; later witness builds execute the tape in C++ over uint64 registers.

Soundness of the uint64 arithmetic is PROVEN at tape-build time by interval
analysis: every register carries [lo, hi] bounds derived from the declared
input bounds; a possible negative subtraction, a bound above 2^62, or a
non-boolean xor operand aborts tape construction, and the caller falls back
to the exact Python builder. Cipher circuits (bit inputs, widest value the
60-bit S-box spread product) pass; the big-field TOPRF circuits fall back.
"""
from __future__ import annotations

import threading

import numpy as np

OP_CONST, OP_ADD, OP_SUB, OP_MULK, OP_MUL, OP_XOR, OP_BIT = 1, 2, 3, 4, 5, 6, 7

_MAX = 1 << 62


class TapeOverflow(Exception):
    """Interval analysis could not prove uint64 safety — use the fallback."""


class _Reg:
    __slots__ = ("idx", "lo", "hi")

    def __init__(self, idx, lo, hi):
        self.idx = idx
        self.lo = lo
        self.hi = hi


class Tape:
    def __init__(self, ops, ra, rb, rd, kk, n_regs, input_regs, wire_regs,
                 hints):
        self.ops = np.asarray(ops, dtype=np.uint8)
        self.ra = np.asarray(ra, dtype=np.int32)
        self.rb = np.asarray(rb, dtype=np.int32)
        self.rd = np.asarray(rd, dtype=np.int32)
        self.kk = np.asarray(kk, dtype=np.int64)
        self.n_regs = n_regs
        self.input_regs = input_regs      # [n_inputs] register of each input wire
        self.wire_regs = np.asarray(wire_regs, dtype=np.int64)
        # hints: [(op_index, fn, [in_regs], [out_regs])] — segment boundaries
        self.hints = hints

    def execute(self, inputs: np.ndarray) -> np.ndarray:
        """inputs: uint64 [n_inputs, batch] -> witness uint64 [n_wires, batch].

        Runs the native executor; raises RuntimeError if the native library
        is unavailable (callers use generate_witness's fallback instead)."""
        from ..native import tape_lib
        lib = tape_lib()
        if lib is None:
            raise RuntimeError("native tape executor unavailable")
        import ctypes
        batch = inputs.shape[1]
        regs = np.zeros((self.n_regs, batch), dtype=np.uint64)
        regs[self.input_regs, :] = inputs
        ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
        args = (ptr(self.ops, ctypes.c_uint8), ptr(self.ra, ctypes.c_int32),
                ptr(self.rb, ctypes.c_int32), ptr(self.rd, ctypes.c_int32),
                ptr(self.kk, ctypes.c_int64))
        start = 0
        n_ops = len(self.ops)
        for (op_idx, fn, in_regs, out_regs) in self.hints:
            rc = lib.zksc_run_tape(*args, start, op_idx,
                                   ptr(regs, ctypes.c_uint64),
                                   self.n_regs, batch)
            if rc:
                raise RuntimeError(f"tape op {rc - 1} failed")
            outs = fn(*[[int(v) for v in regs[r]] for r in in_regs])
            for r, vals in zip(out_regs, outs):
                regs[r, :] = np.asarray([int(v) for v in vals],
                                        dtype=np.uint64)
            start = op_idx
        rc = lib.zksc_run_tape(*args, start, n_ops,
                               ptr(regs, ctypes.c_uint64), self.n_regs, batch)
        if rc:
            raise RuntimeError(f"tape op {rc - 1} failed")
        return regs[self.wire_regs]


class TapeBuilder:
    """Mirror of WitnessBuilder that records instructions instead of values.

    Wire-push order matches WitnessBuilder exactly (alloc_input, mul, xor,
    to_bits, hint outputs), so tape output row i is wire i."""
    is_witness = True

    def __init__(self, input_bound: int = 1):
        self.ops, self.ra, self.rb, self.rd, self.kk = [], [], [], [], []
        self.n_regs = 0
        self.input_regs = []
        self.wire_regs = []
        self.hints = []
        self._input_bound = input_bound
        one = self._const(1)
        self.wire_regs.append(one.idx)     # wire 0

    # -- register helpers --
    def _reg(self, lo, hi) -> _Reg:
        if hi >= _MAX:
            raise TapeOverflow(f"bound {hi} exceeds 2^62")
        if lo < 0:
            raise TapeOverflow("possible negative value")
        r = _Reg(self.n_regs, lo, hi)
        self.n_regs += 1
        return r

    def _emit(self, op, a, b, d, k=0):
        self.ops.append(op)
        self.ra.append(a)
        self.rb.append(b)
        self.rd.append(d)
        self.kk.append(k)

    def _const(self, c: int) -> _Reg:
        if not (0 <= c < _MAX):
            raise TapeOverflow(f"constant {c} out of uint64 tape range")
        r = self._reg(c, c)
        self._emit(OP_CONST, 0, 0, r.idx, c)
        return r

    # -- WitnessBuilder API --
    def alloc_input(self, values=None) -> _Reg:
        r = self._reg(0, self._input_bound)
        self.input_regs.append(r.idx)
        self.wire_regs.append(r.idx)
        return r

    def constant(self, c: int) -> _Reg:
        return self._const(int(c))

    def add(self, *vs) -> _Reg:
        out = vs[0]
        for v in vs[1:]:
            r = self._reg(out.lo + v.lo, out.hi + v.hi)
            self._emit(OP_ADD, out.idx, v.idx, r.idx)
            out = r
        return out

    def sub(self, a: _Reg, b: _Reg) -> _Reg:
        r = self._reg(a.lo - b.hi, a.hi - b.lo)
        self._emit(OP_SUB, a.idx, b.idx, r.idx)
        return r

    def mul_const(self, a: _Reg, k: int) -> _Reg:
        k = int(k)
        if k < 0 or k >= _MAX:
            raise TapeOverflow(f"mul_const by {k}")
        r = self._reg(a.lo * k, a.hi * k)
        self._emit(OP_MULK, a.idx, 0, r.idx, k)
        return r

    def mul(self, a: _Reg, b: _Reg) -> _Reg:
        r = self._reg(a.lo * b.lo, a.hi * b.hi)
        self._emit(OP_MUL, a.idx, b.idx, r.idx)
        self.wire_regs.append(r.idx)
        return r

    def xor(self, a: _Reg, b: _Reg) -> _Reg:
        if a.hi > 1 or b.hi > 1:
            raise TapeOverflow("xor on non-boolean operands")
        r = self._reg(0, 1)
        self._emit(OP_XOR, a.idx, b.idx, r.idx)
        self.wire_regs.append(r.idx)
        return r

    def xor_constrain(self, a, b, out):
        pass

    def mul_eq(self, a, b, c):
        pass

    def assert_bool(self, a):
        # circuit-level boolean assertion: tighten the interval (honest-prover
        # witness generation; a violating hint would fail the constraint
        # either way, in both the tape and the Python builder)
        a.hi = min(a.hi, 1)

    def assert_eq(self, a, b):
        pass

    def to_bits(self, a: _Reg, n: int, hint=None) -> list:
        if a.hi >> n:
            raise TapeOverflow(f"to_bits({n}) on value up to {a.hi}")
        bits = []
        for i in range(n):
            r = self._reg(0, 1)
            self._emit(OP_BIT, a.idx, 0, r.idx, i)
            self.wire_regs.append(r.idx)
            bits.append(r)
        return bits

    def from_bits(self, bits: list) -> _Reg:
        out = self._const(0)
        for i, b in enumerate(bits):
            out = self.add(out, self.mul_const(b, 1 << i))
        return out

    def hint(self, fn, inputs: list, n_out: int) -> list:
        outs = []
        for _ in range(n_out):
            # hint outputs are unconstrained wires; assume field-sized values
            # are NOT produced (cipher hints emit bits / small ints). A hint
            # that can emit large values must be declared via hint_bound.
            r = self._reg(0, self._hint_bound())
            self.wire_regs.append(r.idx)
            outs.append(r)
        self.hints.append((len(self.ops), fn,
                           [i.idx for i in inputs], [o.idx for o in outs]))
        return outs

    def _hint_bound(self) -> int:
        return 1 << 34

    def finish(self) -> Tape:
        return Tape(self.ops, self.ra, self.rb, self.rd, self.kk,
                    self.n_regs, self.input_regs, self.wire_regs, self.hints)


_TAPE_CACHE: dict = {}
_TAPE_LOCK = threading.Lock()     # one build a circuit when threads race


def clear_tape_cache():
    """Invalidate compiled witness tapes. Needed after monkeypatching any
    hint function a circuit references — tapes capture hint callables at
    build time (tests do this; production circuits never re-bind hints)."""
    _TAPE_CACHE.clear()


def build_tape(define_fn, public_layout, private_layout,
               input_bound: int = 1) -> Tape | None:
    """Compile the circuit's witness computation to a Tape, or None if the
    interval analysis rejects it (caller falls back to Python)."""
    # key on the function OBJECT (not id()): holds a reference so a GC'd
    # define_fn's recycled id cannot alias a different circuit's tape
    key = (define_fn, tuple(public_layout), tuple(private_layout))
    with _TAPE_LOCK:
        if key not in _TAPE_CACHE:
            _TAPE_CACHE[key] = _record_tape(define_fn, public_layout,
                                            private_layout, input_bound)
        return _TAPE_CACHE[key]


def _record_tape(define_fn, public_layout, private_layout, input_bound):
    try:
        api = TapeBuilder(input_bound=input_bound)
        vars_ = {}
        for name, count in public_layout:
            vars_[name] = [api.alloc_input() for _ in range(count)]
        for name, count in private_layout:
            vars_[name] = [api.alloc_input() for _ in range(count)]
        define_fn(api, vars_)
        return api.finish()
    except TapeOverflow:
        return None

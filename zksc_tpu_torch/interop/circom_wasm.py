"""circom WASM witness calculator: run the reference's circuit.wasm natively.

The reference's snarkjs operator computes witnesses by executing circom's
compiled WASM calculator (js/src/snarkjs/operator.ts:54-106, the
circom_runtime protocol). This module drives the same `circuit.wasm`
artifacts through our native C++ WASM interpreter (native/wasm_vm.cc), so
witnesses can be generated from the REFERENCE's own circuit definitions —
the missing half of snarkjs-operator parity (SURVEY.md §2.1). The JAX
package's ``interop/circom_wasm.py`` over the port's own build of the VM
(``native.wasm_lib``, which raises when g++ cannot build it).

Protocol (circom 2.x, wasm witness calculator):
  init(sanity_check)
  n32   = getFieldNumLen32()            # field element size in u32 limbs
  prime = read n32 limbs after getRawPrime()
  per input signal:  h = fnv1a64(name); per element:
      writeSharedRWMemory(j, limb_j) for j < n32
      setInputSignal(h >> 32, h & 0xffffffff, position)
  nw = getWitnessSize()
  witness[i] = read n32 limbs after getWitness(i)
"""
from __future__ import annotations

import ctypes
import os

from ..native import wasm_lib


def reference_resources(base: str | None = None) -> str:
    """The reference checkout's resources/ directory: `base`, else
    $ZKSC_REFERENCE_RESOURCES, else ~/reference/resources."""
    return base or os.environ.get(
        "ZKSC_REFERENCE_RESOURCES",
        os.path.join(os.path.expanduser("~"), "reference", "resources"))


def fnv1a64(name: str) -> int:
    h = 0xCBF29CE484222325
    for ch in name:
        h ^= ord(ch)
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class CircomWasmError(RuntimeError):
    pass


# circom runtime error codes (circom_runtime js/witness_calculator.js)
_ERRORS = {
    1: "Signal not found",
    2: "Too many signals set",
    3: "Signal already set",
    4: "Assert failed",
    5: "Not enough signals set",
}


class WitnessCalculator:
    """Executes a circom-compiled circuit.wasm witness generator."""

    def __init__(self, wasm_bytes: bytes, sanity_check: bool = True):
        lib = wasm_lib()
        self._lib = lib
        self._h = lib.wvm_load(wasm_bytes, len(wasm_bytes))
        if not self._h:
            raise CircomWasmError("failed to parse circuit.wasm")
        self.version = self._call("getVersion")
        if self.version != 2:
            raise CircomWasmError(
                f"unsupported witness calculator version {self.version}")
        self._sanity = sanity_check
        self.n32 = self._call("getFieldNumLen32")
        self._call("getRawPrime")
        self.prime = self._read_fr()
        # NB: init(sanityCheck) is re-issued at the start of EVERY
        # calculate_witness (circom_runtime semantics) — it resets the
        # input-signal state, so cached calculators can be reused.
        self._call("init", 1 if sanity_check else 0)
        self.n_witness = self._call("getWitnessSize")
        self.n_inputs = self._call("getInputSize")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and getattr(self, "_lib", None):
            self._lib.wvm_free(h)
            self._h = None

    def _call(self, name: str, *args) -> int:
        c_args = (ctypes.c_uint64 * max(1, len(args)))(*args)
        ret = ctypes.c_uint64(0)
        rc = self._lib.wvm_call(self._h, name.encode(), c_args, len(args),
                                ctypes.byref(ret))
        if rc == -1:
            raise CircomWasmError(f"unknown export {name!r}")
        if rc in (-2, -3):
            raise CircomWasmError(
                f"{name}: arity/result-count mismatch (rc {rc}, "
                f"passed {len(args)} args)")
        if rc != 0:
            code = self._lib.wvm_exception_code(self._h)
            msg = _ERRORS.get(code, f"trap {rc}")
            raise CircomWasmError(
                f"{name} failed: {msg} (code {code}, {self._message()})")
        return int(ret.value)

    def _message(self) -> str:
        """Drain the calculator's error-message buffer (getMessageChar)."""
        out = []
        try:
            for _ in range(256):
                ch = self._call("getMessageChar")
                if ch == 0:
                    break
                out.append(chr(ch & 0x7F))
        except CircomWasmError:
            pass
        return "".join(out) or "no message"

    def _read_fr(self) -> int:
        v = 0
        for j in range(self.n32):
            v |= self._call("readSharedRWMemory", j) << (32 * j)
        return v

    def _write_fr(self, value: int):
        value %= self.prime
        for j in range(self.n32):
            self._call("writeSharedRWMemory", j, (value >> (32 * j))
                       & 0xFFFFFFFF)

    def calculate_witness(self, inputs: dict) -> list:
        """inputs: {signal_name: int | [int, ...] (flattened array)} ->
        witness values as python ints (w[0] == 1)."""
        # circom_runtime calls init(sanityCheck) at the start of every
        # calculation — it resets input-signal state; without it a second
        # calculation on a cached calculator fails with "Too many signals
        # set (code 2)".
        self._call("init", 1 if self._sanity else 0)
        n_set = 0
        for name, vals in inputs.items():
            if isinstance(vals, (int,)):
                vals = [vals]
            h = fnv1a64(name)
            sig_size = self._call("getInputSignalSize",
                                  h >> 32, h & 0xFFFFFFFF)
            if sig_size >= 1 << 31:          # i32 -1: unknown signal
                sig_size -= 1 << 32
            if sig_size >= 0 and sig_size != len(vals):
                raise CircomWasmError(
                    f"signal {name!r} expects {sig_size} values, "
                    f"got {len(vals)}")
            for pos, v in enumerate(vals):
                self._write_fr(int(v))
                self._call("setInputSignal", h >> 32, h & 0xFFFFFFFF, pos)
                n_set += 1
        if n_set != self.n_inputs:
            raise CircomWasmError(
                f"circuit expects {self.n_inputs} input signals, "
                f"got {n_set}")
        out = []
        for i in range(self.n_witness):
            self._call("getWitness", i)
            out.append(self._read_fr())
        return out


def load_reference_calculator(algorithm: str,
                              base: str | None = None) -> WitnessCalculator:
    """Load the reference's circuit.wasm for an algorithm (layout:
    {base}/snarkjs/{algorithm}/circuit.wasm, js/src/file-fetch.ts:71-87)."""
    path = os.path.join(reference_resources(base), "snarkjs", algorithm,
                        "circuit.wasm")
    with open(path, "rb") as f:
        return WitnessCalculator(f.read())


# ---- integration with the engine-neutral witness (ZKProofInput) ----

_CALCULATORS: dict = {}


def _chacha_bits(b: bytes) -> list:
    """chacha serializer: u8 -> u32 LE words -> 32 bits MSB-first per word
    (js/src/config.ts:20-22 via utils.ts toUintArray/uintArrayToBits)."""
    out = []
    for i in range(0, len(b), 4):
        w = int.from_bytes(b[i:i + 4], "little")
        out.extend((w >> (31 - j)) & 1 for j in range(32))
    return out


def _be_bits(b: bytes) -> list:
    """aes serializer: plain BE bits (js/src/utils.ts:72-85)."""
    return [(x >> (7 - j)) & 1 for x in b for j in range(8)]


def reference_witness(wi, base: str | None = None) -> list:
    """Compute the snarkjs witness for a ZKProofInput by executing the
    REFERENCE's circuit.wasm (circom calculator semantics: only the first
    block's nonce/counter are used, js/src/snarkjs/operator.ts:83-89).
    Returns the full witness vector as python ints; wrap with
    snarkjs.write_wtns for a .wtns file."""
    alg = wi.algorithm
    key = (alg, base)
    if key not in _CALCULATORS:
        _CALCULATORS[key] = load_reference_calculator(alg, base)
    wc = _CALCULATORS[key]
    bits = _chacha_bits if alg == "chacha20" else _be_bits
    nonce = wi.blocks[0].nonce
    counter = wi.blocks[0].counter
    return wc.calculate_witness({
        "key": bits(wi.key),
        "nonce": bits(nonce),
        "counter": [(counter >> (31 - j)) & 1 for j in range(32)],
        "in": bits(wi.ciphertext),
    })

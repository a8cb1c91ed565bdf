"""Run the REFERENCE stwo prover/verifier (wasm-bindgen WASM) natively.

The reference's stwo engine ships as a wasm-bindgen module
(resources/stwo/s2circuits_bg.wasm, API at js/src/stwo/s2circuits.d.ts).
This wrapper executes it in the port's native WASM VM (native/wasm_vm.cc),
giving an in-process ORACLE of the reference Circle-STARK backend:
its prover/verifier/keystream can be invoked directly from tests to
cross-check behavior (the README'd path to bit-exact stwo interop).

wasm-bindgen ABI (resources/stwo/s2circuits.js):
  byte args:   ptr = __wbindgen_malloc(len, 1); memory[ptr:ptr+len] = data
  string ret:  fn returns (ptr, len) multi-value; utf-8 at memory[ptr];
               caller frees with __wbindgen_free(ptr, len, 1)
  module init: __wbindgen_start() once after instantiation
"""
from __future__ import annotations

import ctypes
import json
import os

from ..native import wasm_lib
from .circom_wasm import reference_resources


class StwoWasmError(RuntimeError):
    pass


class StwoWasm:
    """The reference stwo WASM module, executed by the native VM."""

    def __init__(self, wasm_bytes: bytes):
        lib = wasm_lib()
        self._lib = lib
        self._h = lib.wvm_load(wasm_bytes, len(wasm_bytes))
        if not self._h:
            raise StwoWasmError("failed to parse s2circuits_bg.wasm")
        self._raw_call("__wbindgen_start")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and getattr(self, "_lib", None):
            self._lib.wvm_free(h)
            self._h = None

    def _raw_call(self, name: str, *args) -> list:
        c_args = (ctypes.c_uint64 * max(1, len(args)))(*args)
        rets = (ctypes.c_uint64 * 8)()
        rc = self._lib.wvm_call_multi(self._h, name.encode(), c_args,
                                      len(args), rets, 8)
        if rc < 0:
            if rc <= -1000:
                msg = self._lib.wvm_trap_message(self._h).decode(
                    "utf-8", "replace")
                raise StwoWasmError(
                    f"{name} trapped (code {-rc - 1000}): "
                    f"{msg or 'no message'}")
            raise StwoWasmError(f"{name}: call error {rc}")
        return [int(rets[i]) for i in range(rc)]

    def _pass_bytes(self, data: bytes) -> tuple:
        (ptr,) = self._raw_call("__wbindgen_malloc", len(data), 1)
        if len(data):
            if self._lib.wvm_write_mem(self._h, ptr, data, len(data)) != 0:
                raise StwoWasmError("malloc'd buffer out of bounds")
        return ptr, len(data)

    def _take_string(self, ptr: int, length: int) -> str:
        buf = (ctypes.c_uint8 * length)()
        if length and self._lib.wvm_read_mem(self._h, ptr, buf, length) != 0:
            raise StwoWasmError("string return out of bounds")
        s = bytes(buf).decode("utf-8", "replace")
        self._raw_call("__wbindgen_free", ptr, length, 1)
        return s

    def _call_str(self, name: str, *args) -> str:
        """Call an export whose wasm-level args are pre-marshalled ints and
        whose return is a (ptr, len) string."""
        ptr, length = self._raw_call(name, *args)
        return self._take_string(ptr, length)

    def _api(self, name: str, byte_args: list, counter: int | None = None,
             counter_pos: int | None = None) -> dict:
        """Marshal byte args (+ an optional i32 counter at position
        counter_pos among the wasm args) and parse the JSON string result."""
        flat = []
        for i, b in enumerate(byte_args):
            if counter_pos is not None and i == counter_pos:
                flat.append(counter & 0xFFFFFFFF)
            ptr, ln = self._pass_bytes(b)
            flat += [ptr, ln]
        if counter_pos is not None and counter_pos == len(byte_args):
            flat.append(counter & 0xFFFFFFFF)
        out = self._call_str(name, *flat)
        try:
            return json.loads(out)
        except json.JSONDecodeError:
            raise StwoWasmError(f"{name}: non-JSON result {out[:200]!r}")

    # ---- public API (mirrors js/src/stwo/s2circuits.d.ts) ----

    def get_circuits_info(self) -> dict:
        return json.loads(self._call_str("get_circuits_info"))

    def debug_chacha20_keystream(self, key: bytes, nonce: bytes,
                                 counter: int) -> dict:
        return self._api("debug_chacha20_keystream", [key, nonce],
                         counter, counter_pos=2)

    def generate_chacha20_proof(self, key, nonce, counter, plaintext,
                                ciphertext) -> dict:
        # wasm args: (key, klen, nonce, nlen, counter, pt, plen, ct, clen)
        kp = self._pass_bytes(key)
        np_ = self._pass_bytes(nonce)
        pp = self._pass_bytes(plaintext)
        cp = self._pass_bytes(ciphertext)
        out = self._call_str("generate_chacha20_proof", *kp, *np_,
                             counter & 0xFFFFFFFF, *pp, *cp)
        return json.loads(out)

    def verify_chacha20_proof(self, proof_b64: str, nonce, counter,
                              plaintext, ciphertext) -> dict:
        sp = self._pass_bytes(proof_b64.encode())
        np_ = self._pass_bytes(nonce)
        pp = self._pass_bytes(plaintext)
        cp = self._pass_bytes(ciphertext)
        out = self._call_str("verify_chacha20_proof", *sp, *np_,
                             counter & 0xFFFFFFFF, *pp, *cp)
        return json.loads(out)

    def generate_aes_ctr_proof(self, key_size: int, key, nonce, counter,
                               plaintext, ciphertext) -> dict:
        name = ("generate_aes128_ctr_proof" if key_size == 16
                else "generate_aes256_ctr_proof")
        kp = self._pass_bytes(key)
        np_ = self._pass_bytes(nonce)
        pp = self._pass_bytes(plaintext)
        cp = self._pass_bytes(ciphertext)
        out = self._call_str(name, *kp, *np_, counter & 0xFFFFFFFF,
                             *pp, *cp)
        return json.loads(out)

    def verify_aes_ctr_proof(self, proof_b64: str, nonce, counter,
                             plaintext, ciphertext) -> dict:
        sp = self._pass_bytes(proof_b64.encode())
        np_ = self._pass_bytes(nonce)
        pp = self._pass_bytes(plaintext)
        cp = self._pass_bytes(ciphertext)
        out = self._call_str("verify_aes_ctr_proof", *sp, *np_,
                             counter & 0xFFFFFFFF, *pp, *cp)
        return json.loads(out)


_INSTANCE = None


def load_reference_stwo(base: str | None = None) -> StwoWasm:
    """Load resources/stwo/s2circuits_bg.wasm from the reference layout."""
    global _INSTANCE
    if _INSTANCE is not None:
        return _INSTANCE
    path = os.path.join(reference_resources(base), "stwo",
                        "s2circuits_bg.wasm")
    with open(path, "rb") as f:
        _INSTANCE = StwoWasm(f.read())
    return _INSTANCE

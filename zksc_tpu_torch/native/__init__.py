"""Native (C++) runtime components, loaded via ctypes.

The reference keeps its witness generation native (Go assignments inside
libprove.so, circom's compiled WASM calculator — SURVEY.md §2.5 item 3);
this package is the port's equivalent: small C++ programs for the host-side
hot paths. Compiled on first use with the system g++ into the package's
`build/` directory (not the source tree). The witness tape has a
pure-Python fallback, so a missing toolchain only costs speed there; the
WASM VM (circom's witness calculator, the reference stwo module) has none,
and `wasm_lib` raises when g++ fails.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
_LOCK = threading.Lock()
_LIB = None
_LIB_TRIED = False
_WASM_LIB = None


def _build(src: str, out: str) -> str | None:
    """g++ src into the shared library out; None on success, else the
    compiler's error text. Builds into a temporary name and renames, so a
    process never loads another's half-written library."""
    tmp = f"{out}.{os.getpid()}.tmp"
    err = ""
    for flags in (["-march=native"], []):   # then the portable fallback
        try:
            subprocess.run(["g++", "-O3", *flags, "-shared", "-fPIC",
                            "-o", tmp, src],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, out)
            return None
        except subprocess.CalledProcessError as e:
            err = e.stderr.decode(errors="replace")
        except (OSError, subprocess.TimeoutExpired) as e:
            err = str(e)
    return err


def _stale(src: str, out: str) -> bool:
    return not os.path.exists(out) or \
        os.path.getmtime(out) < os.path.getmtime(src)


def tape_lib():
    """ctypes handle to the witness-tape executor, or None if unbuildable."""
    global _LIB, _LIB_TRIED
    with _LOCK:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        src = os.path.join(_DIR, "tape_exec.cc")
        os.makedirs(BUILD_DIR, exist_ok=True)
        out = os.path.join(BUILD_DIR, "libzksc_tape.so")
        if _stale(src, out) and _build(src, out) is not None:
            return None
        try:
            lib = ctypes.CDLL(out)
        except OSError:
            return None
        lib.zksc_run_tape.restype = ctypes.c_int
        lib.zksc_run_tape.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),    # ops
            ctypes.POINTER(ctypes.c_int32),    # ra
            ctypes.POINTER(ctypes.c_int32),    # rb
            ctypes.POINTER(ctypes.c_int32),    # rd
            ctypes.POINTER(ctypes.c_int64),    # kk
            ctypes.c_int64, ctypes.c_int64,    # start, end
            ctypes.POINTER(ctypes.c_uint64),   # regs
            ctypes.c_int64, ctypes.c_int64,    # n_regs, batch
        ]
        _LIB = lib
        return _LIB


def wasm_lib():
    """ctypes handle to the WASM interpreter (wasm_vm.cc), built on first
    use. Raises RuntimeError with g++'s message when it cannot be built or
    loaded: there is no fallback VM."""
    global _WASM_LIB
    with _LOCK:
        if _WASM_LIB is not None:
            return _WASM_LIB
        src = os.path.join(_DIR, "wasm_vm.cc")
        os.makedirs(BUILD_DIR, exist_ok=True)
        out = os.path.join(BUILD_DIR, "libzksc_wasm.so")
        if _stale(src, out):
            err = _build(src, out)
            if err is not None:
                raise RuntimeError(f"g++ build of the WASM VM failed: {err}")
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            raise RuntimeError(f"cannot load the WASM VM {out}: {e}") from e
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.wvm_load.restype = ctypes.c_void_p
        lib.wvm_load.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.wvm_free.restype = None
        lib.wvm_free.argtypes = [ctypes.c_void_p]
        lib.wvm_call.restype = ctypes.c_int
        lib.wvm_call.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u64p,
                                 ctypes.c_int, u64p]
        lib.wvm_call_multi.restype = ctypes.c_int
        lib.wvm_call_multi.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       u64p, ctypes.c_int, u64p,
                                       ctypes.c_int]
        lib.wvm_exception_code.restype = ctypes.c_uint32
        lib.wvm_exception_code.argtypes = [ctypes.c_void_p]
        lib.wvm_trap_message.restype = ctypes.c_char_p
        lib.wvm_trap_message.argtypes = [ctypes.c_void_p]
        lib.wvm_read_mem.restype = ctypes.c_int
        lib.wvm_read_mem.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                     ctypes.POINTER(ctypes.c_uint8),
                                     ctypes.c_uint32]
        lib.wvm_write_mem.restype = ctypes.c_int
        lib.wvm_write_mem.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                      ctypes.c_char_p, ctypes.c_uint32]
        _WASM_LIB = lib
        return _WASM_LIB

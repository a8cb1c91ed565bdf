"""Native (C++) runtime components, loaded via ctypes.

The reference keeps its witness generation native (Go assignments inside
libprove.so, circom's compiled WASM calculator — SURVEY.md §2.5 item 3);
this package is the port's equivalent: small C++ kernels for the host-side
hot paths. Compiled on first use with the system g++ into the package's
`build/` directory (not the source tree); every user has a pure-Python
fallback, so a missing toolchain only costs speed.
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


def _build(src: str, out: str) -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", out, src],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        try:  # retry without -march=native (portable fallback)
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", out, src],
                check=True, capture_output=True, timeout=120)
            return True
        except Exception:
            return False


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
        if not os.path.exists(out) or \
                os.path.getmtime(out) < os.path.getmtime(src):
            if not _build(src, out):
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

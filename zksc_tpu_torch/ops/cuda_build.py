"""Build and load the hand-written CUDA kernels (csrc/) for sm_90a.

Each library is one plain ``nvcc`` call on one ``.cu`` source into a shared
library with a C interface, loaded with ctypes: no PyTorch header and no
torch.utils.cpp_extension, so a build takes seconds. ``build()`` starts the
nvcc of every library that is missing or older than its sources at once
and waits for all of them; ``load(name)`` builds on first use.

    ec   csrc/ec_kernels.cu  -> build/libzksc_ec.so   (K1 chunk_scan, K2 jac_add_n)
    msm  csrc/msm_kernels.cu -> build/libzksc_msm.so  (K3 ladder)
    stark csrc/stark_kernels.cu -> build/libzksc_stark.so (K7a blake2s,
         K7b circle_fft and circle_layer, K7c composition, K7d
         aes_composition)
    h    csrc/h_kernels.cu   -> build/libzksc_h.so    (the Groth16 H pass
         over Fr: K0 fr_elementwise, K4 ntt_group, K5 sparse_matvec)
    msm_glue csrc/msm_glue.cu -> build/libzksc_msm_glue.so (the bucket
         MSM's glue, K6: K6a msm_keys, K6b sorted_gather, K6c scan_top,
         K6d segment_prefix and bucket)
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIBS = {
    "ec": ("ec_kernels.cu", ("bn254.cuh",), "libzksc_ec.so"),
    "msm": ("msm_kernels.cu", ("bn254.cuh",), "libzksc_msm.so"),
    "stark": ("stark_kernels.cu", ("m31.cuh",), "libzksc_stark.so"),
    "h": ("h_kernels.cu", ("bn254.cuh",), "libzksc_h.so"),
    "msm_glue": ("msm_glue.cu", ("bn254.cuh",), "libzksc_msm_glue.so"),
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LOADED: dict = {}


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, LIBS[name][2])


def _stale(name: str) -> bool:
    src, headers, _ = LIBS[name]
    out = lib_path(name)
    if not os.path.exists(out):
        return True
    return any(os.path.getmtime(out) < os.path.getmtime(os.path.join(CSRC, s))
               for s in (src, *headers))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(names=None, verbose: bool = False) -> dict:
    """Compile the named libraries (default: all) that are missing or stale,
    all nvcc processes running together. Returns {name: (seconds in nvcc,
    nvcc's output)} ((0.0, "") for a library that was up to date); raises
    if a build fails. verbose adds ``-Xptxas -v`` (registers and spill of
    every kernel) and prints the output."""
    names = list(LIBS) if names is None else list(names)
    todo = [n for n in names if _stale(n)]
    res = {n: (0.0, "") for n in names}
    if not todo:
        return res
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = lib_path(n) + f".{os.getpid()}.tmp"
        cmd = [_nvcc(), *(["-Xptxas", "-v"] if verbose else []), *NVCC_FLAGS,
               "-o", tmp, os.path.join(CSRC, LIBS[n][0])]
        log = tempfile.TemporaryFile(mode="w+")
        procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                     text=True), tmp, log, time.time())
    failed = []
    pending = set(procs)
    while pending:                     # each library's own seconds
        for n in sorted(pending):
            proc, tmp, log, t0 = procs[n]
            if proc.poll() is None:
                continue
            pending.discard(n)
            log.seek(0)
            out = log.read()
            log.close()
            res[n] = (time.time() - t0, out)
            if proc.returncode != 0:
                failed.append(f"{LIBS[n][0]} ({proc.returncode}):\n{out}")
                continue
            if verbose:
                print(f"--- nvcc {LIBS[n][0]}: {res[n][0]:.2f} s\n{out}", flush=True)
            os.replace(tmp, lib_path(n))
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return res


def load(name: str, declare) -> ctypes.CDLL:
    """The ctypes library `name`, built if needed; `declare(lib)` sets the
    argument and result types once."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(lib_path(name))
            declare(lib)
            _LOADED[name] = lib
        return lib

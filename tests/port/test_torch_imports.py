"""The port stands alone: no module of zksc_tpu_torch, nor chip_smoke.py,
imports jax or the JAX package; its entry points refuse to run without CUDA
unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PKG = os.path.join(ROOT, "zksc_tpu_torch")


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "examples", "toprf_threshold_service_torch.py")
    for tool in ("artifacts_cli", "profile_prove", "bench_stark",
                 "stwo_crosscheck", "run_imported_r1cs_e2e",
                 "gen_oneblock_artifacts", "msm_stage"):
        yield os.path.join(ROOT, "tools", f"{tool}_torch.py")
    yield os.path.join(ROOT, "tests", "port", "torch_multihost_worker.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "zksc_tpu")


def test_no_jax_imports_in_source():
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(path, n) for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {ROOT!r})
import zksc_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(zksc_tpu_torch.__path__,
                                              "zksc_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "zksc_tpu"))
assert not bad, bad
print(" ".join(mods))
"""
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    mods = out.stdout.split()
    assert len(mods) >= 27
    assert {"zksc_tpu_torch.stark.aes_air",
            "zksc_tpu_torch.stark.aes_prover"} <= set(mods)
    assert {f"zksc_tpu_torch.stark.stwo_compat.{m}" for m in (
        "air", "cfft", "channel", "circle", "codec", "field", "fri", "merkle",
        "prover", "quotients", "trace", "verifier")} <= set(mods)
    assert {f"zksc_tpu_torch.{m}" for m in (
        "file_fetch", "utils.logging", "interop.cbor", "interop.intcomp",
        "interop.gnark_r1cs", "interop.gnark", "interop.snarkjs",
        "interop.circom_wasm", "interop.stwo_wasm")} <= set(mods)
    assert {f"zksc_tpu_torch.{m}" for m in (
        "parallel.mesh", "parallel.multihost", "ops.ntt_sharded",
        "ops.msm_glue")} <= set(mods)


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_refuse_without_cuda(monkeypatch):
    from zksc_tpu_torch import api
    from zksc_tpu_torch.groth16 import ProverContext
    from zksc_tpu_torch.operators import Groth16Operator, StarkOperator
    from zksc_tpu_torch.stark import merkle
    from zksc_tpu_torch.stark import prover as sp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.generate_proof("chacha20", bytes(32), bytes(128), bytes(12))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.generate_proofs("chacha20", [])
    env = api.ProofEnvelope("chacha20", {}, bytes(128), 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.verify_proof(env, bytes(128), bytes(12))
    with pytest.raises(RuntimeError, match="CUDA"):
        Groth16Operator("chacha20")
    with pytest.raises(RuntimeError, match="CUDA"):
        ProverContext(None, None)
    # the stark engine's entry points
    with pytest.raises(RuntimeError, match="CUDA"):
        api.generate_proof("chacha20", bytes(32), bytes(128), bytes(12),
                           engine="stark")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.verify_proof(env, bytes(128), bytes(12), engine="stark")
    with pytest.raises(RuntimeError, match="CUDA"):
        sp.prove_stream(bytes(32), bytes(12), 1, bytes(128), bytes(128),
                        device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        sp.verify_stream(None, bytes(12), 1, bytes(128), bytes(128))
    with pytest.raises(RuntimeError, match="CUDA"):
        StarkOperator("chacha20")
    # the AES statements under the stark engine
    from zksc_tpu_torch.stark import aes_prover as ap
    with pytest.raises(RuntimeError, match="CUDA"):
        api.generate_proof("aes-128-ctr", bytes(16), bytes(80), bytes(12),
                           engine="stark")
    with pytest.raises(RuntimeError, match="CUDA"):
        ap.prove_aes_ctr(bytes(16), bytes(12), 2, bytes(80), bytes(80))
    with pytest.raises(RuntimeError, match="CUDA"):
        ap.verify_aes_ctr(None, bytes(12), 2, bytes(80), bytes(80), 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        StarkOperator("aes-256-ctr")
    with pytest.raises(RuntimeError, match="CUDA"):
        merkle.commit(np.zeros((4, 16), dtype=np.uint8))
    # the stark-stwo engine's entry points
    from zksc_tpu_torch.operators import StwoCompatOperator
    from zksc_tpu_torch.stark.stwo_compat import prover as wp
    with pytest.raises(RuntimeError, match="CUDA"):
        api.generate_proof("chacha20", bytes(32), bytes(128), bytes(12),
                           engine="stark-stwo")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.generate_proofs("chacha20", [], engine="stark-stwo")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.verify_proof(env, bytes(128), bytes(12), engine="stark-stwo")
    with pytest.raises(RuntimeError, match="CUDA"):
        wp.prove_stream(bytes(32), bytes(12), 1, bytes(128), bytes(128))
    with pytest.raises(RuntimeError, match="CUDA"):
        wp.prove_stream_bytes(bytes(32), bytes(12), 1, bytes(128), bytes(128))
    with pytest.raises(RuntimeError, match="CUDA"):
        StwoCompatOperator("chacha20")
    # the multi-device layer: a mesh naming CUDA raises, as do the tools
    from zksc_tpu_torch.parallel import mesh, multihost
    for make in (mesh.make_mesh, lambda: mesh.make_mesh(2, ["cuda"]),
                 multihost.local_mesh, multihost.global_mesh,
                 lambda: ProverContext(None, None, mesh=mesh.make_mesh(2))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    monkeypatch.setenv("ZKSC_MESH", "2")
    with pytest.raises(RuntimeError, match="CUDA"):
        Groth16Operator("chacha20")
    from test_torch_tools import load_tool
    for tool in ("profile_prove_torch", "bench_stark_torch",
                 "gen_oneblock_artifacts_torch"):
        with pytest.raises(RuntimeError, match="CUDA"):
            load_tool(tool).main([])


def test_aes_composition_wrapper_refuses_cpu_tensors():
    """K7d's wrapper launches on CUDA tensors only: no fallback on the CPU."""
    from zksc_tpu_torch.ops import stark_kernels
    from zksc_tpu_torch.stark import aes_air
    idx, off, n, rows = stark_kernels.pack_aes_groups(aes_air.layout(16)[2])
    hdr, srows = stark_kernels.aes_slice_table(idx, off, n, rows,
                                               stark_kernels.aes_slices(n))
    vals = torch.zeros((max(rows) + 1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        stark_kernels.aes_composition(
            vals, torch.arange(8, dtype=torch.int32),
            (torch.from_numpy(hdr), torch.from_numpy(srows), n, int(srows.max())),
            (0,) * 8,
            torch.zeros((stark_kernels.aes_n_constraints(n), 4), dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32))

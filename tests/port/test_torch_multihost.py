"""Port vs reference: multi-process orchestration (parallel/multihost.py).

host_slice equals the JAX package's over the reference test's cases;
initialize() with no cluster in the environment is a no-op returning
False; two processes over gloo on 127.0.0.1 form a 4-shard global mesh
and run the sharded NTT across the process boundary
(torch_multihost_worker.py), each within a 120 s timeout."""
import os
import socket
import subprocess
import sys

import pytest
import torch

from zksc_tpu.parallel import multihost as jmh
from zksc_tpu_torch.parallel import multihost

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CLUSTER_ENV = ("ZKSC_COORDINATOR", "ZKSC_NUM_PROCS", "ZKSC_PROC_ID")


def test_host_slice_matches_jax():
    for n_items in (0, 1, 7, 8, 10, 23, 100):
        for n_procs in (1, 2, 3, 8):
            covered = []
            for p in range(n_procs):
                s = multihost.host_slice(n_items, process_id=p,
                                         num_processes=n_procs)
                assert s == jmh.host_slice(n_items, process_id=p,
                                           num_processes=n_procs)
                covered.extend(range(n_items)[s])
            assert covered == list(range(n_items)), (n_items, n_procs)
    # a single process owns the whole batch
    assert multihost.host_slice(10) == slice(0, 10)


def test_initialize_without_cluster_is_a_noop(monkeypatch):
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    # without a process group the global mesh is the local one
    m = multihost.global_mesh(devices=["cpu", "cpu", "cpu"])
    assert m.size == 3 and m.all_local
    # half a cluster description is an error, not a silent single process
    monkeypatch.setenv("ZKSC_NUM_PROCS", "2")
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize()


def test_default_backend(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert multihost.default_backend(2) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert multihost.default_backend(2) == "gloo"
    assert multihost.default_backend(1) == "nccl"


def test_two_process_sharded_ntt():
    worker = os.path.join(HERE, "torch_multihost_worker.py")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k not in CLUSTER_ENV}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), str(port), ROOT],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"MULTIHOST-NTT-OK proc={pid}" in out

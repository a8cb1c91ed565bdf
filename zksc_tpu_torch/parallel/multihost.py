"""Multi-process orchestration: torch.distributed init, the global and
local meshes, and the split of a request batch across processes.

The JAX package's ``parallel/multihost.py`` model, unchanged:

  - within a process, one proof's MSM and NTT lane axes shard over the
    local mesh (parallel/mesh.py, ops/msm.py, ops/ntt_sharded.py);
  - across processes, proving stays embarrassingly parallel: each process
    proves its own slice of the request batch (`host_slice`), and no proof
    needs a collective across processes.

A global mesh spans the shards of every process; ops/ntt_sharded.py
exchanges its butterfly blocks across the process boundary with
torch.distributed point-to-point operations. Nothing here discovers a
cluster: the coordinator address, the process count and this process's
rank come from the arguments or from ZKSC_COORDINATOR, ZKSC_NUM_PROCS and
ZKSC_PROC_ID.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

TIMEOUT_S = 120


def default_backend(num_processes: int) -> str:
    """NCCL where every process can have a card of its own, else gloo
    (which moves CUDA tensors through the host)."""
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> bool:
    """Idempotently join the process group. Arguments default to
    ZKSC_COORDINATOR ("host:port"), ZKSC_NUM_PROCS and ZKSC_PROC_ID. With
    none of them set (and no group already), returns False: a single
    process. Returns True once distributed mode is active."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "ZKSC_COORDINATOR")
    if num_processes is None and "ZKSC_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["ZKSC_NUM_PROCS"])
    if process_id is None and "ZKSC_PROC_ID" in os.environ:
        process_id = int(os.environ["ZKSC_PROC_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or \
            process_id is None:
        raise ValueError("a cluster needs the coordinator address, the "
                         "process count and this process's id")
    backend = backend or default_backend(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    init = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_mesh(devices=None) -> Mesh:
    """Mesh over this process's devices only (default: its visible CUDA
    devices; `devices` as in make_mesh)."""
    return make_mesh(None, devices)


def global_mesh(devices=None) -> Mesh:
    """1-D mesh over every process's shards, in rank order: process r
    holds shards [r*Dl, (r+1)*Dl), on its `devices` (default: its visible
    CUDA devices). Every process must bring the same count Dl. Without a
    process group, the local mesh."""
    local = local_mesh(devices)
    if not dist.is_initialized():
        return local
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, local.size)
    if len(set(counts)) != 1:
        raise ValueError(f"processes bring unequal shard counts {counts}")
    rank, Dl = dist.get_rank(), local.size
    ranks = [r for r in range(len(counts)) for _ in range(Dl)]
    devs = [local.devices[d - rank * Dl] if r == rank else None
            for d, r in enumerate(ranks)]
    return Mesh(devs, ranks, rank)


def host_slice(n_items: int, process_id: int | None = None,
               num_processes: int | None = None) -> slice:
    """Contiguous slice of a request batch owned by this process: n_items
    split as evenly as possible, the first `rem` processes taking one
    extra. Each process proves requests[host_slice(len(requests))] on its
    own devices, with no communication at all."""
    p = process_id if process_id is not None else process_index()
    n = num_processes if num_processes is not None else process_count()
    base, rem = divmod(n_items, n)
    start = p * base + min(p, rem)
    stop = start + base + (1 if p < rem else 0)
    return slice(start, stop)

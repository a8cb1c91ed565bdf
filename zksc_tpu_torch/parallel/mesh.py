"""Device mesh and lane placement for the prover.

The JAX package's ``parallel/mesh.py`` shards the point-lane (last) axis of
its arrays over a 1-D ``jax.sharding.Mesh`` and lets XLA insert the
collectives. PyTorch has no single-controller sharded array, so here:

  - a ``Mesh`` is an ordered tuple of ``torch.device``s, one per shard.
    Shard d may sit on any device, and a device may hold several shards:
    a mesh of D shards on one card (or on the CPU) runs the very same
    sharded programs one shard after another, which is how the tests and
    the one-card smoke test exercise meshes of 2-8 shards.
  - a lane-sharded array is a Python list of D tensors: block d holds
    lanes [d*C, (d+1)*C) of the whole array (C = N / D) and lies on
    ``mesh.devices[d]``. Under a multi-process mesh (parallel/multihost.py)
    the blocks of other processes' shards are None.

The sharded code (ops/ntt_sharded.py, ops/msm.py, groth16/prove.py) runs
the one-device functions on every local block and moves data between
blocks explicitly; the same arithmetic in the same order, so every sharded
result equals the one-device result limb for limb.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.ec import JacPoint

SHARD_AXIS = "shard"


class Mesh:
    """A 1-D mesh of shards. devices[d]: the device of shard d, None where
    another process holds it; ranks[d]: the rank of the process that holds
    shard d; rank: this process's rank."""

    def __init__(self, devices, ranks=None, rank: int = 0):
        self.devices = tuple(None if d is None else torch.device(d)
                             for d in devices)
        self.ranks = (tuple(ranks) if ranks is not None
                      else (rank,) * len(self.devices))
        self.rank = rank
        if len(self.ranks) != len(self.devices) or not self.devices:
            raise ValueError("a mesh needs one rank per shard, and a shard")
        for d, dev in enumerate(self.devices):
            if (dev is None) != (self.ranks[d] != rank):
                raise ValueError(f"shard {d}: a device exactly where this "
                                 "process holds the shard")

    @property
    def size(self) -> int:
        return len(self.devices)

    def is_local(self, d: int) -> bool:
        return self.ranks[d] == self.rank

    @property
    def local_shards(self) -> list:
        return [d for d in range(self.size) if self.is_local(d)]

    @property
    def all_local(self) -> bool:
        return all(r == self.rank for r in self.ranks)

    def __repr__(self):
        return f"Mesh({list(self.devices)}, ranks={list(self.ranks)})"


def visible_devices() -> list:
    """Every visible CUDA device; raises without CUDA."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of n_devices shards over `devices` (default: the visible CUDA
    devices, as the reference takes jax.devices()). Shard d lies on
    devices[d % len(devices)]: with fewer devices than shards the devices
    repeat, so make_mesh(4, ["cpu"]) is four shards on the CPU and
    make_mesh(4) on one card four shards on that card. A device naming
    CUDA where there is none raises."""
    devs = (visible_devices() if devices is None
            else [resolve_device(d) for d in devices])
    if not devs:
        raise ValueError("a mesh needs at least one device")
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    return Mesh([devs[d % len(devs)] for d in range(n)])


class Sharding:
    """Placement of an array's last axis over a mesh, in D contiguous
    blocks. fold=2 for G2 coordinates, which hold (c0 | c1) folded along
    the lane axis ([L, 2N]): each block keeps both halves of its N / D
    points ([L, 2N / D]), so the shards split points, not components."""

    def __init__(self, mesh: Mesh, fold: int = 1):
        self.mesh = mesh
        self.fold = fold

    def block_width(self, x) -> int:
        n = x.shape[-1] // self.fold
        if n % self.mesh.size:
            raise ValueError(f"{n} lanes do not tile a mesh of "
                             f"{self.mesh.size}")
        return n // self.mesh.size

    def shard(self, x) -> list:
        """Full tensor [..., fold*N] -> contiguous blocks, as the kernels
        take them (None for other processes' shards)."""
        C = self.block_width(x)
        lead = x.shape[:-1]
        xf = x.reshape(*lead, self.fold, -1)
        out = []
        for d, dev in enumerate(self.mesh.devices):
            if dev is None:
                out.append(None)
                continue
            blk = xf[..., d * C:(d + 1) * C].reshape(*lead, self.fold * C)
            out.append(blk.to(dev).contiguous())
        return out

    def gather(self, blocks, device=None):
        """Blocks of every shard -> the full tensor on `device` (default:
        shard 0's device)."""
        if any(b is None for b in blocks):
            raise ValueError("gather needs every shard's block in this "
                             "process")
        dev = blocks[0].device if device is None else device
        lead = blocks[0].shape[:-1]
        parts = [b.to(dev).reshape(*lead, self.fold, -1) for b in blocks]
        return torch.cat(parts, dim=-1).reshape(*lead, -1)


def lane_sharding(mesh: Mesh, fold: int = 1) -> Sharding:
    """Sharding for [L, N] limb arrays (fold=2: folded G2 [L, 2N])."""
    return Sharding(mesh, fold)


def bits_sharding(mesh: Mesh) -> Sharding:
    """Sharding for [n_bits, (k,) N] scalar-bit arrays."""
    return Sharding(mesh)


def shard_jac(pt: JacPoint, mesh: Mesh, g2: bool = False) -> list:
    """A JacPoint batch -> one JacPoint per shard (None for other
    processes' shards)."""
    sh = lane_sharding(mesh, 2 if g2 else 1)
    xs, ys, zs = (sh.shard(a) for a in pt)
    return [None if x is None else JacPoint(x, y, z)
            for x, y, z in zip(xs, ys, zs)]


def shard_bits(bits, mesh: Mesh) -> list:
    return bits_sharding(mesh).shard(bits)


def replicate(x, mesh: Mesh) -> list:
    """x on every local shard's device (None for other processes')."""
    return [None if dev is None else x.to(dev) for dev in mesh.devices]

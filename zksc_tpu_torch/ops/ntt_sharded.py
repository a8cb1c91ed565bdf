"""Mesh-sharded radix-2 NTT: butterfly stages with exchanges between shards.

The JAX package's ``ops/ntt_sharded.py``, over the port's mesh
(parallel/mesh.py): the lane axis of ops/ntt.py's bit-reversal-free DIF /
DIT transforms is split into D contiguous blocks of C = n / D lanes.

  - a stage whose butterfly span exceeds C pairs block d with block
    d XOR (span / 2C) (a hypercube exchange), log2(D) such stages in all.
    Inside one process the partner's block is copied to d's device; across
    processes it travels by torch.distributed point-to-point operations
    (batch_isend_irecv; gloo stages CUDA blocks through the host).
  - the remaining stages are block-local and reuse NTTContext's stage
    tables as they are: for spans <= C the n-point transform's twiddles
    restricted to one block are the same powers.

The results equal NTTContext's limb for limb: the same arithmetic in the
same order, the DIF / DIT stages only grouped into exchanged and local
parts. Plain PyTorch, as the one-device transforms are.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.mesh import Mesh, lane_sharding
from .ntt import NTTContext, dif_stages, dit_stages


def xor_exchange(blocks: list, mesh: Mesh, h: int) -> list:
    """out[d] = blocks[d ^ h] on shard d's device, for every local shard
    d (None elsewhere). A partner in another process sends its block by
    torch.distributed point-to-point, tagged with the sending shard. A
    failed send or receive raises."""
    out = [None] * mesh.size
    ops, recvs = [], []
    gloo = dist.is_initialized() and dist.get_backend() == "gloo"
    for d in mesh.local_shards:
        p = d ^ h
        if mesh.is_local(p):
            out[d] = blocks[p].to(mesh.devices[d])
            continue
        send = blocks[d].to("cpu" if gloo else mesh.devices[d]).contiguous()
        recv = torch.empty_like(send)
        ops.append(dist.P2POp(dist.isend, send, mesh.ranks[p], tag=d))
        ops.append(dist.P2POp(dist.irecv, recv, mesh.ranks[p], tag=p))
        recvs.append((d, recv))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for d, recv in recvs:
            out[d] = recv.to(mesh.devices[d])
    return out


class ShardedNTT:
    """Sharded transforms of an NTTContext over a 1-D mesh of D shards (D
    a power of two dividing n). Transforms take and return lane-sharded
    arrays: lists of D blocks [L, n / D] (None for other processes'
    shards); `sharding` places and gathers them. The NTT's tables are
    copied once to each device the mesh names."""

    def __init__(self, ntt: NTTContext, mesh: Mesh):
        self.ntt = ntt
        self.mesh = mesh
        D = self.D = mesh.size
        if ntt.n % D or D & (D - 1):
            raise ValueError(f"a mesh of {D} shards does not tile the "
                             f"{ntt.n}-point domain")
        self.C = ntt.n // D
        self.sharding = lane_sharding(mesh)
        self._tables = {}

    def _tab(self, dev):
        key = str(dev)
        if key not in self._tables:
            nt = self.ntt
            move = lambda t: {k: v.to(dev) for k, v in t.items()}
            self._tables[key] = {
                "inv": move(nt._tw_inv), "fwd": move(nt._tw_fwd),
                "ninv": nt._ninv.to(dev),
                "shift": nt.shift_pows_br.to(dev),
                "shift_inv": nt.shift_inv_pows_br.to(dev)}
        return self._tables[key]

    def _local(self, blocks, fn):
        return [None if b is None else fn(d, b, self._tab(b.device))
                for d, b in enumerate(blocks)]

    def _check(self, blocks):
        if len(blocks) != self.D:
            raise ValueError(f"{len(blocks)} blocks for a mesh of {self.D}")
        for d in self.mesh.local_shards:
            if blocks[d] is None or blocks[d].shape[-1] != self.C:
                raise ValueError(f"shard {d} needs a block of {self.C} lanes")

    def _cross_dif(self, blocks, length):
        F, C = self.ntt.F, self.C
        h = (length // 2) // C
        others = xor_exchange(blocks, self.mesh, h)

        def stage(d, x, tab):
            if d & h:       # v half: (u - v) * tw at the global offset t0
                t0 = ((d % (2 * h)) - h) * C
                tw = tab["inv"][length][:, t0:t0 + C]
                return F.mont_mul(F.sub(others[d], x), tw)
            return F.add(x, others[d])
        return self._local(blocks, stage)

    def _cross_dit(self, blocks, length):
        F, C = self.ntt.F, self.C
        h = (length // 2) // C
        others = xor_exchange(blocks, self.mesh, h)

        def stage(d, x, tab):
            # both halves use the twiddle of the v element's position
            is_v = bool(d & h)
            u, v = (others[d], x) if is_v else (x, others[d])
            dv = d if is_v else d + h
            tv0 = ((dv % (2 * h)) - h) * C
            vw = F.mont_mul(v, tab["fwd"][length][:, tv0:tv0 + C])
            return F.sub(u, vw) if is_v else F.add(u, vw)
        return self._local(blocks, stage)

    def dif_inverse(self, evals: list) -> list:
        """evals (natural order) -> coeffs (bit-reversed), with the 1/n
        scale."""
        self._check(evals)
        F, C = self.ntt.F, self.C
        x, length = evals, self.ntt.n
        while length > C:
            x = self._cross_dif(x, length)
            length //= 2
        return self._local(x, lambda d, b, tab: F.mont_mul(
            dif_stages(F, b, tab["inv"], C), tab["ninv"]))

    def dit_forward(self, coeffs_br: list) -> list:
        """coeffs (bit-reversed) -> evals (natural order)."""
        self._check(coeffs_br)
        F, C = self.ntt.F, self.C
        x = self._local(coeffs_br,
                        lambda d, b, tab: dit_stages(F, b, tab["fwd"], C))
        length = 2 * C
        while length <= self.ntt.n:
            x = self._cross_dit(x, length)
            length *= 2
        return x

    def _scale(self, blocks, name):
        F, C = self.ntt.F, self.C
        return self._local(blocks, lambda d, b, tab: F.mont_mul(
            b, tab[name][:, d * C:(d + 1) * C]))

    def coset_evals_from_coeffs_br(self, coeffs_br: list) -> list:
        self._check(coeffs_br)
        return self.dit_forward(self._scale(coeffs_br, "shift"))

    def coeffs_br_from_coset_evals(self, evals: list) -> list:
        return self._scale(self.dif_inverse(evals), "shift_inv")

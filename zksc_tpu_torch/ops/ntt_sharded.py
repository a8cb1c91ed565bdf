"""Mesh-sharded radix-2 NTT: butterfly stages with exchanges between shards.

The JAX package's ``ops/ntt_sharded.py``, over the port's mesh
(parallel/mesh.py): the lane axis of ops/ntt.py's bit-reversal-free DIF /
DIT transforms is split into D contiguous blocks of C = n / D lanes.

  - a stage whose butterfly span exceeds C pairs block d with block
    d XOR (span / 2C) (a hypercube exchange), log2(D) such stages in all.
    Inside one process the partner's block is copied to d's device; across
    processes it travels by torch.distributed point-to-point operations
    (batch_isend_irecv; gloo stages CUDA blocks through the host).
  - the remaining stages are block-local: for spans <= C the n-point
    transform restricted to one block is the C-point transform with root
    w^D, whose twiddles are the same powers.

A transform is NTTContext's (dif, dit, scale) form: the exchanged DIF
stages, then on each block its local DIF stages, the product by the
block's slice of the scale table and its local DIT stages, then the
exchanged DIT stages. The results equal NTTContext's limb for limb: the
same arithmetic, the DIF / DIT stages only grouped into exchanged and
local parts. On CUDA blocks the local part is one K4 launch sequence a
block (ops/h_kernels.ntt over the C-point tables: every D-th entry of the
n-point ones) and each exchanged stage one K0 launch a block
(h_kernels.cross_stage); on CPU blocks both run their plain versions.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.mesh import Mesh, lane_sharding
from . import h_kernels
from .ntt import NTTContext, _lift, dif_stages, dit_stages


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
    """Sharded transforms of an NTTContext over BN254 Fr on a 1-D mesh of D
    shards (D a power of two dividing n). Transforms take and return
    lane-sharded arrays: lists of D blocks [L, *rows, n / D] (None for
    other processes' shards); `sharding` places and gathers them. The
    NTT's tables are copied once to each device the mesh names."""

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
        """The tables on `dev`: the n-point packed twiddles (the exchanged
        stages), the C-point ones (every D-th entry) and the packed scale
        tables for K4; the stage tables of spans <= C and the scale tables
        in limbs for the plain version."""
        key = str(dev)
        if key not in self._tables:
            nt, D = self.ntt, self.D
            tw_inv, tw_fwd, scales = nt._kernel_tables()
            tab = {"inv": tw_inv.to(dev), "fwd": tw_fwd.to(dev),
                   "inv_local": tw_inv[::D].contiguous().to(dev),
                   "fwd_local": tw_fwd[::D].contiguous().to(dev),
                   "scale_words": {k: v.to(dev) for k, v in scales.items()},
                   "stages_inv": {k: v.to(dev) for k, v in
                                  nt._tw_inv.items() if k <= self.C},
                   "stages_fwd": {k: v.to(dev) for k, v in
                                  nt._tw_fwd.items() if k <= self.C},
                   "scales": {k: v.to(dev) for k, v in nt._scales.items()}}
            self._tables[key] = tab
        return self._tables[key]

    def _check(self, blocks):
        if len(blocks) != self.D:
            raise ValueError(f"{len(blocks)} blocks for a mesh of {self.D}")
        for d in self.mesh.local_shards:
            if blocks[d] is None or blocks[d].shape[-1] != self.C:
                raise ValueError(f"shard {d} needs a block of {self.C} lanes")

    def _cross(self, blocks, length: int, dif: bool):
        """The stage of span `length` > C: block d pairs with block d ^ h.
        DIF: the v half's twiddles sit at the global offset of its block;
        DIT: both halves use the twiddles of the v element's position."""
        C = self.C
        h = (length // 2) // C
        stride = self.ntt.n // length
        others = xor_exchange(blocks, self.mesh, h)
        out = []
        for d, x in enumerate(blocks):
            if x is None:
                out.append(None)
                continue
            v_half = bool(d & h)
            dv = d if v_half or dif else d + h
            t0 = max(((dv % (2 * h)) - h) * C, 0)    # DIF u half: unused
            tw = self._tab(x.device)["inv" if dif else "fwd"]
            out.append(h_kernels.cross_stage(x, others[d], tw, t0, stride,
                                             dif, v_half))
        return out

    def _local_block(self, d: int, x, dif: bool, dit: bool, scale):
        """The stages of spans <= C of block d (the C-point transform with
        root w^D), the product by its slice of the scale table named
        `scale` between them: K4 on a CUDA block, else _local_plain."""
        if not h_kernels._on_card(x):
            return self._local_plain(d, x, dif, dit, scale)
        tab, C = self._tab(x.device), self.C
        sc = None
        if scale is not None:
            sc = tab["scale_words"][scale]
            sc = sc if sc.shape[0] == 1 else sc[d * C:(d + 1) * C]
        return h_kernels.ntt(x.contiguous(), tab["inv_local"],
                             tab["fwd_local"], dif, dit, sc)

    def _local_plain(self, d: int, x, dif: bool, dit: bool, scale):
        F, C, tab = self.ntt.F, self.C, self._tab(x.device)
        if dif:
            x = dif_stages(F, x, tab["stages_inv"], C)
        if scale is not None:
            s = tab["scales"][scale]
            s = s if s.shape[-1] == 1 else s[:, d * C:(d + 1) * C]
            x = F.mont_mul(x, _lift(s, x))
        if dit:
            x = dit_stages(F, x, tab["stages_fwd"], C)
        return x

    def _transform(self, blocks, dif: bool, dit: bool, scale):
        """NTTContext._transform over the blocks: the exchanged DIF stages,
        each block's local stages and scale, the exchanged DIT stages."""
        self._check(blocks)
        x, n, C = blocks, self.ntt.n, self.C
        length = n
        while dif and length > C:
            x = self._cross(x, length, True)
            length //= 2
        x = [None if b is None else self._local_block(d, b, dif, dit, scale)
             for d, b in enumerate(x)]
        length = 2 * C
        while dit and length <= n:
            x = self._cross(x, length, False)
            length *= 2
        return x

    def dif_inverse(self, evals: list) -> list:
        """evals (natural order) -> coeffs (bit-reversed), with the 1/n
        scale."""
        return self._transform(evals, True, False, "ninv")

    def dit_forward(self, coeffs_br: list) -> list:
        """coeffs (bit-reversed) -> evals (natural order)."""
        return self._transform(coeffs_br, False, True, None)

    def coset_evals_from_coeffs_br(self, coeffs_br: list) -> list:
        return self._transform(coeffs_br, False, True, "shift")

    def coeffs_br_from_coset_evals(self, evals: list,
                                   from_mont: bool = False) -> list:
        """With from_mont, as plain residues (NTTContext's form)."""
        return self._transform(evals, True, False, "ninv_shift_inv_plain"
                               if from_mont else "ninv_shift_inv")

    def coset_evals_from_evals(self, evals: list) -> list:
        """evaluations on the domain (natural) -> on the coset (natural):
        each block's local DIF, scale and DIT in one K4 call."""
        return self._transform(evals, True, True, "ninv_shift")

"""Groth16 prover: witness -> proof, with the MSMs and NTTs on the device.

Pipeline (the JAX package's ``groth16/prove.py``):

  1. sparse A/B/C constraint evaluation over the three matrices stacked
     as one CSR matrix (ops/h_kernels.sparse_matvec: the kernel K5 on the
     GPU; the plain version a gather + a lazy per-limb segment sum)
  2. H(x) quotient via coset NTT (ops/ntt.py, bit-reversal-free pipeline;
     the kernel K4 on the GPU) and the pointwise quotient (K0), one pass
     for the k proofs of a batch (_h_pipeline_batch)
  3. five MSMs (A, B1, C and H over G1, B2 over G2): bucket MSMs
     (ops/msm.py, point additions in the kernels K1/K2 on the GPU) for
     m_pad >= 256 or with force_pippenger, else batched double-and-add
     ladders (ops/ec.py:msm_double_and_add, the kernel K3 on the GPU); B2
     on the host for m_pad <= 64
  4. final blinding combine (r, s) on the host — a handful of point ops.

With a mesh (parallel/mesh.py), the quotient runs sharded
(_build_sharded_h: each shard's row slice of the mat-vec and
ops/ntt_sharded.py, on K0 / K4 / K5 on the GPU), every bucket MSM splits
its points over the shards, and the ladders run one K3 per shard over its
lanes; the partial sums are added on the host, so the proof equals the
one-device proof.
"""
from __future__ import annotations

import functools
import secrets
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..curve import bn254_host as host
from ..device import resolve_device
from ..fields.limb import Fp, Fr
from ..ops import ec, h_kernels, msm
from ..ops.ntt import NTTContext
from ..r1cs.builder import ConstraintSystem
from .setup import ProvingKey


@dataclass
class Proof:
    a: tuple          # G1 affine
    b: tuple          # G2 affine
    c: tuple          # G1 affine

    def to_json_dict(self) -> dict:
        """snarkjs-shaped proof JSON (decimal strings, projective z=1)."""
        return {
            "pi_a": [str(self.a[0]), str(self.a[1]), "1"],
            "pi_b": [[str(self.b[0][0]), str(self.b[0][1])],
                     [str(self.b[1][0]), str(self.b[1][1])], ["1", "0"]],
            "pi_c": [str(self.c[0]), str(self.c[1]), "1"],
            "protocol": "groth16",
            "curve": "bn128",
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "Proof":
        a = (int(d["pi_a"][0]), int(d["pi_a"][1]))
        b = ((int(d["pi_b"][0][0]), int(d["pi_b"][0][1])),
             (int(d["pi_b"][1][0]), int(d["pi_b"][1][1])))
        c = (int(d["pi_c"][0]), int(d["pi_c"][1]))
        return cls(a, b, c)


def _expand_u64_limbs(lo, hi, L: int):
    """(lo, hi) u32 planes of a u64 value array (as int64 tensors) ->
    [L, *shape] 16-bit limb stack (plain, non-Montgomery), int32."""
    limbs = [lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16]
    zero = torch.zeros_like(lo)
    return torch.stack(limbs + [zero] * (L - 4)).to(torch.int32)


class ProverContext:
    """Device-side structures for one circuit: sparse matrices, NTT tables
    and the proving key (whose tables must already be on `device`)."""

    def __init__(self, cs: ConstraintSystem, pk: ProvingKey, device=None,
                 force_pippenger: bool = False, mesh=None):
        """force_pippenger: use the bucket MSMs even for tiny circuits (the
        default routes m_pad < 256 to the double-and-add ladders).

        mesh: optional parallel.mesh.Mesh whose shards all lie in this
        process: shards the quotient pipeline and every MSM's point lanes
        over its devices (the default device is then shard 0's). Proofs
        equal the one-device proofs: the sharded arithmetic is the same,
        and EC group addition is exact and associative, so the partition
        of the lanes cannot change a point."""
        if mesh is not None and device is None:
            device = mesh.devices[0]
        self.device = resolve_device(device)
        if mesh is not None and not mesh.all_local:
            raise ValueError("a prover's mesh needs every shard in this "
                             "process (across processes, split the batch: "
                             "parallel.multihost.host_slice)")
        self.cs = cs
        self.pk = pk
        self.mesh = mesh
        self.force_pippenger = force_pippenger
        self._b2_host_pts = None     # lazy host copy of b_g2_query (tiny cs)
        self.timings: dict = {}
        self.ntt = NTTContext(Fr, pk.domain_n, device=self.device)
        self.m_pad = int(pk.a_query.x.shape[-1])
        self.c_pad = int(pk.c_query.x.shape[-1])
        # COO sparse matrices (coefficients in Montgomery form on the device)
        self._mats = []
        for sel in range(3):
            rows, cols, coeffs = [], [], []
            for k, lcs in enumerate(cs.constraints):
                for wire, coeff in lcs[sel].items():
                    rows.append(k)
                    cols.append(wire)
                    coeffs.append(coeff)
            self._mats.append((
                torch.as_tensor(np.asarray(rows, dtype=np.int64),
                                device=self.device),
                torch.as_tensor(np.asarray(cols, dtype=np.int64),
                                device=self.device),
                Fr.to_device(coeffs, device=self.device),
            ))
        self._csr = h_kernels.CSR.stack(self._mats, self.ntt.n)
        self._zinv = pow(self.ntt.z_coset_int, -1, host.R)
        self._h_sharded = self._build_sharded_h(mesh) if mesh is not None \
            else None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _build_sharded_h(self, mesh):
        """Mesh-sharded quotient pipeline, the JAX package's
        _build_sharded_h on the port's mesh, shard d holding lanes
        [d C, (d + 1) C) of the domain:

        - sparse A/B/C eval: shard d takes the CSR slice of its own rows of
          A, B and C (three stacked matrices of C rows), so one mat-vec
          (K5 on a CUDA block) writes its block of A z, B z, C z. The
          reference shards the nonzeros and reduce-scatters the partial
          row sums; the canonical sums mod r are the same. The CPU path
          takes the row slice too.
        - NTTs: ops/ntt_sharded.ShardedNTT, the coset pass as one transform
          over the block's three rows, the way back with from_mont folded
          in; the quotient of each block (K0).

        Equal to the one-device _h_core limb for limb. Returns None when
        the domain does not tile the mesh."""
        from ..ops.ntt_sharded import ShardedNTT
        from ..parallel.mesh import replicate

        D, n = mesh.size, self.ntt.n
        if n % D != 0 or (n // D) < 2:
            return None
        sntt = ShardedNTT(self.ntt, mesh)
        C = n // D
        csrs = []
        for d, dev in enumerate(mesh.devices):
            part = []
            for rows, cols, coeffs in self._mats:
                sel = (rows >= d * C) & (rows < (d + 1) * C)
                part.append((rows[sel] - d * C, cols[sel], coeffs[:, sel]))
            csrs.append(h_kernels.CSR.stack(part, C).to(dev))

        def h_core_sharded(z_mont_1):
            zw = h_kernels.pack_z(z_mont_1[:, None].contiguous())
            abc = [h_kernels.sparse_matvec(z, csr).reshape(Fr.L, 3, C)
                   for z, csr in zip(replicate(zw, mesh), csrs)]
            cs = sntt.coset_evals_from_evals(abc)
            h_cs = [h_kernels.quotient(c, self._zinv) for c in cs]
            h_br = sntt.coeffs_br_from_coset_evals(h_cs, from_mont=True)
            return sntt.sharding.gather(h_br, device=self.device)

        return h_core_sharded

    def _ladder_msm(self, fops, q: ec.JacPoint, bits, n_bits: int) -> list:
        """Device half of a ladder MSM over k scalar sets: one width-k
        JacPoint per shard. With a mesh of D shards that tiles the lanes,
        each shard runs the ladder and its reduction (K3) over its own
        lanes; without, one JacPoint over all of them."""
        from ..parallel.mesh import shard_bits, shard_jac
        mesh = self.mesh
        if mesh is None or mesh.size == 1 or \
                fops.lane_width(q.x) % mesh.size:
            return [ec.msm_double_and_add(fops, q, bits, n_bits)]
        g2 = isinstance(fops, ec.Fp2Ops)
        return [ec.msm_double_and_add(fops, qd, bd, n_bits)
                for qd, bd in zip(shard_jac(q, mesh, g2),
                                  shard_bits(bits, mesh))]

    @staticmethod
    def _ladder_to_host(fops, parts: list, k: int) -> list:
        """Per-shard ladder sums -> k host affine points (the D partials
        added on the host)."""
        g2 = isinstance(fops, ec.Fp2Ops)
        conv = ec.g2_jac_to_host_affine if g2 else ec.g1_jac_to_host_affine
        add = host.g2_add if g2 else host.g1_add
        pts = [conv(Fp, p, host.P)[:k] for p in parts]
        return [functools.reduce(add, (p[j] for p in pts)) for j in range(k)]

    def _b2_msm_host(self, witness):
        """sum_i z_i * B2_i on host Jacobian bigints (tiny circuits only —
        see host_b2 in prove_batch). Returns host affine."""
        g = host
        if self._b2_host_pts is None:
            self._b2_host_pts = ec.g2_jac_to_host_affine(
                Fp, self.pk.b_g2_query, g.P)
        acc = None
        for v, Q in zip(witness, self._b2_host_pts):
            v = int(v) % g.R
            if Q is None or v == 0:
                continue
            acc = g.jac_add_host(acc, g.jac_mul_host(Q, v, g2=True), g2=True)
        return g.jac_to_affine_host(acc, g2=True)

    def witness_to_device(self, witness: np.ndarray):
        """One host witness [n_wires] -> (z_mont [L, m_pad], z_bits
        [n_bits, m_pad], n_bits). The ladder length adapts to the widest
        witness value (40, 64, 128 or 254 bits): cipher circuits keep every
        wire below 2^34."""
        z_mont, z_plain, n_bits = self._witnesses_to_device([witness])
        z_plain = z_plain[:, 0]
        return z_mont[:, 0], ec.scalars_to_bits(Fr, z_plain, n_bits), n_bits

    def _h_pipeline_batch(self, z_mont):
        """The quotient of k proofs in one pass: z_mont [L, k, m_pad] -> h
        [L, k, n] plain limbs (bit-reversed coefficient order, matching the
        h_query layout). Every op takes the whole batch, so the number of
        ops launched does not depend on k (the JAX package vmaps its
        one-proof program over the proof axis). On the GPU: one K0 launch
        packs z, one K5 launch computes A z, B z and C z, the three coset
        transforms are one K4 pass over their 3k rows, then one K0
        quotient and one K4 pass back (from_mont folded in)."""
        L, k = z_mont.shape[0], z_mont.shape[1]
        n = self.ntt.n
        abc = h_kernels.sparse_matvec(h_kernels.pack_z(z_mont.contiguous()),
                                      self._csr)
        # abc: [L, 3, k, n], A z, B z, C z
        cs = self.ntt.coset_evals_from_evals(abc.reshape(L, 3 * k, n))
        h_cs = h_kernels.quotient(cs.reshape(L, 3, k, n), self._zinv)
        return self.ntt.coeffs_br_from_coset_evals(h_cs, from_mont=True)

    def _h_core(self, z_mont_1):
        """One proof's quotient: z_mont [L, m_pad] -> h [L, n] plain limbs."""
        return self._h_pipeline_batch(z_mont_1[:, None])[:, 0]

    def compute_h_batch(self, z_mont):
        """z_mont [L, k, m_pad] -> h [L, k, n] plain limbs: one pass over the
        k proofs, or, when the mesh tiles the domain, one sharded pass a
        proof, as the JAX package does."""
        if self._h_sharded is None:
            return self._h_pipeline_batch(z_mont)
        return torch.stack([self._h_sharded(z_mont[:, j])
                            for j in range(z_mont.shape[1])], dim=1)

    def prove(self, witness: np.ndarray, rng=None) -> Proof:
        """witness: full wire-value vector [n_wires] (ints)."""
        return self.prove_batch([witness], rng)[0]

    def prove_batch(self, witnesses: list, rng=None) -> list:
        """Prove k independent witnesses in one pass (the proof axis rides
        in the MSM lane batch). rng: callable () -> int for the blinding
        scalars r, s; defaults to a cryptographically secure source."""
        if rng is None:
            rng = lambda: secrets.randbelow(host.R)
        pk = self.pk
        k = len(witnesses)
        t = [time.perf_counter()]

        def mark():
            self._sync()
            t.append(time.perf_counter())

        z_mont, z_plain, nb = self._witnesses_to_device(witnesses)
        mark()
        h_plain = self.compute_h_batch(z_mont)          # [L, k, n] plain limbs
        mark()
        ell = pk.n_public + 1
        priv_plain = z_plain[:, :, ell:ell + self.c_pad]
        if priv_plain.shape[2] < self.c_pad:
            priv_plain = torch.nn.functional.pad(
                priv_plain, (0, self.c_pad - priv_plain.shape[2]))

        # B2 on the host for tiny circuits: a <= 64-point host Jacobian MSM
        # (exact group math, identical proofs either way)
        host_b2 = self.m_pad <= 64
        if host_b2:
            b2_pts = [self._b2_msm_host(w) for w in witnesses]

        if self.m_pad >= 256 or self.force_pippenger:
            # bucket MSMs (points split over the mesh's shards, if any);
            # all launch before any host read-back: only the affine
            # conversions below synchronise
            mh = self.mesh
            a_dev = msm.msm_pippenger_device(ec.G1_OPS, pk.a_query, z_plain,
                                             nb, mesh=mh)
            b1_dev = msm.msm_pippenger_device(ec.G1_OPS, pk.b_g1_query,
                                              z_plain, nb, mesh=mh)
            if not host_b2:
                b2_dev = msm.msm_pippenger_device(ec.G2_OPS, pk.b_g2_query,
                                                  z_plain, nb, mesh=mh)
            c_dev = msm.msm_pippenger_device(ec.G1_OPS, pk.c_query,
                                             priv_plain, nb, mesh=mh)
            h_dev = msm.msm_pippenger_device(ec.G1_OPS, pk.h_query, h_plain,
                                             254, mesh=mh)
            mark()
            a_pts = msm.msm_to_host_affine(ec.G1_OPS, a_dev, k)
            b1_pts = msm.msm_to_host_affine(ec.G1_OPS, b1_dev, k)
            if not host_b2:
                b2_pts = msm.msm_to_host_affine(ec.G2_OPS, b2_dev, k)
            c_pts = msm.msm_to_host_affine(ec.G1_OPS, c_dev, k)
            h_pts = msm.msm_to_host_affine(ec.G1_OPS, h_dev, k)
        else:
            # tiny circuits: batched double-and-add ladders, the proof axis
            # folded into the lanes and reduced per segment (per shard, with
            # a mesh)
            z_bits = ec.scalars_to_bits(Fr, z_plain, nb)
            priv_bits = ec.scalars_to_bits(Fr, priv_plain, nb)
            h_bits = ec.scalars_to_bits(Fr, h_plain, 254)
            G1, G2 = ec.G1_OPS, ec.G2_OPS
            a_msm = self._ladder_msm(G1, pk.a_query, z_bits, nb)
            b1_msm = self._ladder_msm(G1, pk.b_g1_query, z_bits, nb)
            if not host_b2:
                b2_msm = self._ladder_msm(G2, pk.b_g2_query, z_bits, nb)
            c_msm = self._ladder_msm(G1, pk.c_query, priv_bits, nb)
            h_msm = self._ladder_msm(G1, pk.h_query, h_bits, 254)
            mark()
            a_pts = self._ladder_to_host(G1, a_msm, k)
            b1_pts = self._ladder_to_host(G1, b1_msm, k)
            if not host_b2:
                b2_pts = self._ladder_to_host(G2, b2_msm, k)
            c_pts = self._ladder_to_host(G1, c_msm, k)
            h_pts = self._ladder_to_host(G1, h_msm, k)

        proofs = []
        g = host
        for j in range(k):
            r_blind, s_blind = rng(), rng()
            A = g.g1_add(g.g1_add(pk.alpha_g1, a_pts[j]),
                         g.g1_mul(pk.delta_g1, r_blind))
            B = g.g2_add(g.g2_add(pk.beta_g2, b2_pts[j]),
                         g.g2_mul(pk.delta_g2, s_blind))
            B1 = g.g1_add(g.g1_add(pk.beta_g1, b1_pts[j]),
                          g.g1_mul(pk.delta_g1, s_blind))
            C = g.g1_add(g.g1_add(c_pts[j], h_pts[j]),
                         g.g1_add(g.g1_mul(A, s_blind),
                                  g.g1_add(g.g1_mul(B1, r_blind),
                                           g.g1_mul(pk.delta_g1,
                                                    (-r_blind * s_blind) % host.R))))
            proofs.append(Proof(a=A, b=B, c=C))
        t.append(time.perf_counter())
        self.timings = {
            "witness_to_device_s": t[1] - t[0],
            "h_pipeline_s": t[2] - t[1],
            "msm_device_s": t[3] - t[2],
            "host_combine_blind_s": t[4] - t[3],
        }
        return proofs

    def _witnesses_to_device(self, witnesses: list):
        """[k] witness vectors -> (z_mont [L, k, m_pad], z_plain
        [L, k, m_pad], n_bits)."""
        k = len(witnesses)
        raw_bits = 1
        arr = np.zeros((k, self.m_pad), dtype=np.uint64)
        big_vals = None
        for j, wit in enumerate(witnesses):
            wnp = np.asarray(wit)
            if wnp.dtype == np.uint64:
                # native-tape witnesses: already canonical uint64 (< 2^62)
                arr[j, : wnp.shape[0]] = wnp
                mx = int(wnp.max()) if wnp.size else 1
                raw_bits = max(raw_bits, mx.bit_length(), 1)
                continue
            vals = [int(v) % host.R for v in wit]
            rb = max((v.bit_length() for v in vals), default=1)
            raw_bits = max(raw_bits, rb, 1)
            if rb <= 64:
                arr[j, : len(vals)] = vals
            else:
                if big_vals is None:
                    big_vals = {}
                big_vals[j] = vals
        n_bits = next(b for b in (40, 64, 128, 254) if raw_bits <= b)
        if big_vals is None:
            # ship the compact u64 witness as two u32 planes and split limbs
            # on the device
            lo = torch.as_tensor((arr & 0xFFFFFFFF).astype(np.int64),
                                 device=self.device)
            hi = torch.as_tensor((arr >> 32).astype(np.int64),
                                 device=self.device)
            z_plain = _expand_u64_limbs(lo, hi, Fr.L)
        else:
            cols = []
            for j in range(k):
                vals = big_vals.get(j)
                if vals is None:
                    vals = [int(v) for v in arr[j]]
                else:
                    vals = vals + [0] * (self.m_pad - len(vals))
                cols.append(Fr.to_device(vals, mont=False, device=self.device))
            z_plain = torch.stack(cols, dim=1)
        z_mont = h_kernels.to_mont(z_plain)
        return z_mont, z_plain, n_bits

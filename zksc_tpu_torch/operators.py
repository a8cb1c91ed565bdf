"""Engine operators: the Groth16 prover/verifier for one algorithm.

Ported from the JAX package's ``operators.py`` for the six statements
(chacha20, aes-128-ctr, aes-256-ctr and their ``-toprf`` variants) under
the "groth16" engine. The STARK engines and the multi-device mesh are not
ported yet; asking for them raises.
"""
from __future__ import annotations

import os
import time

import numpy as np

from .api import PORTED_ALGORITHMS, ZKProofInput
from .config import CONFIG
from .device import resolve_device
from .oprf.locations import compute_bitmask
from .oprf.oprf import lagrange_coeff
from .r1cs import check_witness, compile_circuit, generate_witness
from .r1cs.circuits import aes as aes_circuit
from .r1cs.circuits import chacha20 as chacha_circuit
from .r1cs.circuits import toprf_variants

ARTIFACT_ROOT = os.environ.get(
    "ZKSC_ARTIFACT_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "artifacts"))


class CircuitSpec:
    """Statement registry entry: circuit definition + witness assembly."""

    def __init__(self, algorithm: str):
        if algorithm not in PORTED_ALGORITHMS:
            raise ValueError(f"algorithm {algorithm!r} is not ported yet "
                             f"({', '.join(PORTED_ALGORITHMS)})")
        self.algorithm = algorithm
        cfg = CONFIG[algorithm]
        self.blocks = cfg.blocks_per_chunk
        key_bits = cfg.key_size_bytes * 8
        if algorithm.endswith("-toprf"):
            self.module = toprf_variants
            self.define = toprf_variants.make_define(
                algorithm, self.blocks, key_bits)
            self.pub_layout = toprf_variants.public_layout(
                algorithm, self.blocks)
            self.priv_layout = toprf_variants.private_layout(
                algorithm, self.blocks, key_bits)
        elif algorithm == "chacha20":
            self.module = chacha_circuit
            self.define = chacha_circuit.make_define(self.blocks)
            self.pub_layout = chacha_circuit.public_layout(self.blocks)
            self.priv_layout = chacha_circuit.private_layout(self.blocks)
        else:
            self.module = aes_circuit
            self.define = aes_circuit.make_define(self.blocks, key_bits)
            self.pub_layout = aes_circuit.public_layout(self.blocks)
            self.priv_layout = aes_circuit.private_layout(self.blocks, key_bits)
        self._cs = None

    @property
    def cs(self):
        if self._cs is None:
            self._cs = compile_circuit(self.define, self.pub_layout,
                                       self.priv_layout)
        return self._cs

    def build_witness(self, wi: ZKProofInput) -> np.ndarray:
        bs = CONFIG[wi.algorithm].block_size_bytes
        ins = [[wi.ciphertext[b * bs:(b + 1) * bs] for b in range(self.blocks)]]
        outs = [[wi.plaintext[b * bs:(b + 1) * bs] for b in range(self.blocks)]]
        infos = [[(blk.nonce, blk.counter) for blk in wi.blocks]]
        if wi.algorithm.endswith("-toprf"):
            bnds = [bs if blk.boundary is None else blk.boundary
                    for blk in wi.blocks]
            total_bits = 8 * bs * self.blocks
            bitmask = compute_bitmask(total_bits, wi.toprf.locations, bnds, bs)
            total_len = sum(l[1] if isinstance(l, tuple) else l.length
                            for l in wi.toprf.locations)
            indices = [r.index for r in wi.toprf.responses]
            tp = {
                "toprf_domain": [[int.from_bytes(wi.toprf.domain_separator,
                                                 "big")]],
                "toprf_resp": [], "toprf_coeff": [], "toprf_share_pub": [],
                "toprf_c": [], "toprf_r": [],
                "toprf_out": [[int(wi.toprf.output)]],
            }
            for r in wi.toprf.responses:
                tp["toprf_resp"] += [[int(r.evaluated[0])],
                                     [int(r.evaluated[1])]]
                tp["toprf_share_pub"] += [[int(r.public_key[0])],
                                          [int(r.public_key[1])]]
                tp["toprf_coeff"].append([lagrange_coeff(indices, r.index)])
                tp["toprf_c"].append([int(r.c)])
                tp["toprf_r"].append([int(r.r)])
            pub, priv = self.module.witness_inputs(
                wi.algorithm, [wi.key], infos, ins, outs, self.blocks,
                bitmasks=[bitmask], lens=[total_len], toprf_pubs=[tp],
                masks=[wi.mask])
        else:
            pub, priv = self.module.witness_inputs([wi.key], infos, ins, outs,
                                                   self.blocks)
        w = generate_witness(self.define, self.pub_layout, self.priv_layout,
                             pub, priv, batch=1)
        return w[:, 0]


class Groth16Operator:
    """Groth16 prove/verify for one algorithm on `device` (default "cuda").

    Keys come from `artifact_dir` (default artifacts/<algorithm>) when it
    holds a pk.npz, else from the port's key store
    (zksc_tpu_torch/build/artifacts/<algorithm>, what keygen writes). With
    neither, and `allow_setup`, the trusted setup runs on the device and its
    keys are saved into the key store, never under artifacts/. The circuit
    digest is pinned on every load."""

    def __init__(self, algorithm: str, artifact_dir: str | None = None,
                 allow_setup: bool = True, device=None):
        from .keygen import KEY_STORE
        self.device = resolve_device(device)
        self.spec = CircuitSpec(algorithm)
        self.algorithm = algorithm
        self._dir = artifact_dir or os.path.join(ARTIFACT_ROOT, algorithm)
        self._store = os.path.join(KEY_STORE, algorithm)
        self._allow_setup = allow_setup
        self._ctx = None
        self._vk = None
        self.timings: dict = {}

    def _key_dir(self) -> str | None:
        """The directory whose pk.npz the prover loads, if any."""
        for d in (self._dir, self._store):
            if os.path.exists(os.path.join(d, "pk.npz")):
                return d
        return None

    def _ensure_keys(self):
        if self._ctx is not None:
            return
        from .groth16 import ProverContext, artifacts as art, setup
        cs = self.spec.cs
        d = self._key_dir()
        if d is not None:
            pk, vk = art.load_keys(d, expected_digest=cs.digest(),
                                   device=self.device)
        elif self._allow_setup:
            pk, vk = setup(cs, device=self.device)
            art.save_keys(self._store, pk, vk)
        else:
            raise FileNotFoundError(
                f"no proving key for {self.algorithm} under {self._dir} or "
                f"{self._store}, and setup disabled")
        self._ctx = ProverContext(cs, pk, device=self.device)
        self._vk = vk

    def ensure_vk(self):
        """The verifying key of the proving key in use; without one, the
        vk.json of `artifact_dir` (a key whose pk.npz is not here)."""
        if self._vk is None:
            from .groth16 import artifacts as art
            d = self._key_dir() or self._dir
            if os.path.exists(os.path.join(d, "vk.json")):
                self._vk = art.load_vk(
                    d, expected_digest=self.spec.cs.digest())
            else:
                self._ensure_keys()
        return self._vk

    def prove(self, wi: ZKProofInput, rng=None) -> dict:
        return self.prove_batch([wi], rng)[0]

    def prove_batch(self, wis: list, rng=None) -> list:
        """Prove several chunks in one device pass."""
        self._ensure_keys()
        t0 = time.perf_counter()
        witnesses = [self.spec.build_witness(wi) for wi in wis]
        if os.environ.get("ZKSC_CHECK_WITNESS", "0") == "1":
            for witness in witnesses:
                if not check_witness(self.spec.cs, witness[:, None]):
                    raise ValueError("witness does not satisfy the circuit "
                                     "(wrong key or corrupted inputs?)")
        t1 = time.perf_counter()
        proofs = self._ctx.prove_batch(witnesses, rng)
        self.timings = {"witness_s": t1 - t0, **self._ctx.timings}
        return [p.to_json_dict() for p in proofs]

    def verify(self, public_bits: list, proof_data: dict) -> bool:
        from .groth16 import verify as g16_verify
        from .groth16.prove import Proof
        vk = self.ensure_vk()
        try:
            proof = Proof.from_json_dict(proof_data)
        except (KeyError, ValueError, TypeError):
            return False
        return g16_verify(vk, proof, public_bits)


def make_operator(algorithm: str, engine: str, device=None):
    if engine == "groth16":
        return Groth16Operator(algorithm, device=device)
    raise ValueError(f"engine {engine!r} is not ported yet (available: groth16)")

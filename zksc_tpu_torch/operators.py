"""Engine operators: the prover/verifier of one algorithm under one engine.

Ported from the JAX package's ``operators.py``: the six statements
(chacha20, aes-128-ctr, aes-256-ctr and their ``-toprf`` variants) under
the "groth16" engine, chacha20, aes-128-ctr and aes-256-ctr under the
"stark" engine (Circle STARK over M31), and chacha20 under "stark-stwo"
(byte-identical stwo proofs). Under "groth16" a prover may shard over a
mesh of devices (``mesh=`` or ZKSC_MESH). The reference proves the
``-toprf`` statements under "groth16" only and runs "stark-stwo" for
chacha20 only; asking for any other pair raises in both packages.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

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
    digest is pinned on every load.

    mesh: a parallel.mesh.Mesh to shard each proof over; without one,
    ZKSC_MESH opts in: "all" (every visible CUDA device) or a shard count
    n (make_mesh(n): on fewer cards the cards repeat; on the CPU, n shards
    of the CPU). A mesh is used only when it has more than one shard."""

    def __init__(self, algorithm: str, artifact_dir: str | None = None,
                 allow_setup: bool = True, device=None, mesh=None):
        from .keygen import KEY_STORE
        self.device = resolve_device(device)
        if mesh is None:
            env = os.environ.get("ZKSC_MESH", "")
            if env:
                from .parallel.mesh import make_mesh
                cuda = self.device.type == "cuda"
                n = (torch.cuda.device_count() if cuda else 1) \
                    if env == "all" else int(env)
                if n > 1:
                    mesh = make_mesh(n, None if cuda else [self.device])
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
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
        self._ctx = ProverContext(cs, pk, device=self.device,
                                  mesh=self.mesh)
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
        if len(wis) > 1:
            # independent witness builds, in order: the native tape's ctypes
            # call releases the GIL, so the threads overlap their tape runs
            with ThreadPoolExecutor(max_workers=min(4, len(wis))) as ex:
                witnesses = list(ex.map(self.spec.build_witness, wis))
        else:
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


class StarkOperator:
    """Circle-STARK engine ("stark") on `device` (default "cuda"): single
    nonce, sequential counters, the proof as the base64-bincode envelope.
    chacha20 uses the stream AIR (stark/prover.py); aes-128-ctr and
    aes-256-ctr use the LogUp lookup AIR (stark/aes_prover.py). The
    blinding bytes come from secrets.token_bytes (prove_stream and
    prove_aes_ctr take others)."""

    ALGORITHMS = ("chacha20", "aes-128-ctr", "aes-256-ctr")

    def __init__(self, algorithm: str, device=None):
        if algorithm not in self.ALGORITHMS:
            raise ValueError(
                f"stark engine: {algorithm!r} is not ported yet (ported: "
                f"{', '.join(self.ALGORITHMS)})")
        self.device = resolve_device(device)
        self.algorithm = algorithm
        self.timings: dict = {}

    @staticmethod
    def _check_blocks(blocks):
        nonce = blocks[0].nonce
        counter0 = blocks[0].counter
        for i, b in enumerate(blocks):
            if b.nonce != nonce or b.counter != counter0 + i:
                raise ValueError("stark engine requires a single nonce and "
                                 "sequential counters (reference stwo parity)")
        return nonce, counter0

    def prove(self, wi: ZKProofInput, rng=None) -> dict:
        if rng is not None:
            raise ValueError("the stark engine takes no rng: its blinding "
                             "bytes come from secrets.token_bytes")
        nonce, counter0 = self._check_blocks(wi.blocks)
        timings = {}
        if self.algorithm == "chacha20":
            from .stark import prover as sp
            proof = sp.prove_stream(wi.key, nonce, counter0, wi.plaintext,
                                    wi.ciphertext, device=self.device,
                                    timings=timings)
        else:
            from .stark import aes_prover as ap
            proof = ap.prove_aes_ctr(wi.key, nonce, counter0, wi.plaintext,
                                     wi.ciphertext, device=self.device,
                                     timings=timings)
        self.timings = timings
        return proof.to_envelope()

    def prove_batch(self, wis: list, rng=None) -> list:
        return [self.prove(wi, rng) for wi in wis]

    def _public_inputs(self, public_bits: list):
        """The engine-neutral signal vector from api.get_public_signals (per
        block: counter LE bits, nonce bits, ciphertext bits, plaintext bits)
        decoded back to (nonce, counter0, plaintext, ciphertext); None if it
        is not one chunk of a single nonce and sequential counters. Raises
        ValueError on a non-bit signal."""
        cfg = CONFIG[self.algorithm]
        bs = cfg.block_size_bytes
        per_block = 32 + 96 + 8 * bs + 8 * bs
        if len(public_bits) != per_block * cfg.blocks_per_chunk:
            return None

        def bits_to_bytes(bits):
            out = bytearray(len(bits) // 8)
            for i, b in enumerate(bits):
                if int(b) not in (0, 1):
                    raise ValueError("non-bit public signal")
                out[i // 8] |= int(b) << (i % 8)
            return bytes(out)

        nonce = counter0 = None
        cts, pts = [], []
        for blk in range(cfg.blocks_per_chunk):
            off = blk * per_block
            ctr = int.from_bytes(
                bits_to_bytes(public_bits[off:off + 32]), "little")
            nnc = bits_to_bytes(public_bits[off + 32:off + 128])
            cts.append(bits_to_bytes(
                public_bits[off + 128:off + 128 + 8 * bs]))
            pts.append(bits_to_bytes(
                public_bits[off + 128 + 8 * bs:off + per_block]))
            if blk == 0:
                nonce, counter0 = nnc, ctr
            elif nnc != nonce or ctr != counter0 + blk:
                return None
        return nonce, counter0, b"".join(pts), b"".join(cts)

    def verify(self, public_bits: list, proof_data: dict) -> bool:
        """public_bits: the engine-neutral signal vector from
        api.get_public_signals. Any exception gives False."""
        try:
            inputs = self._public_inputs(public_bits)
            if inputs is None:
                return False
            nonce, counter0, pt, ct = inputs
            if self.algorithm == "chacha20":
                from .stark import prover as sp
                proof = sp.StreamProof.from_json_dict(proof_data)
                return sp.verify_stream(proof, nonce, counter0, pt, ct,
                                        device=self.device)
            from .stark import aes_prover as ap
            proof = ap.AesProof.from_json_dict(proof_data)
            return ap.verify_aes_ctr(proof, nonce, counter0, pt, ct,
                                     CONFIG[self.algorithm].key_size_bytes,
                                     device=self.device)
        except Exception:
            return False


class StwoCompatOperator(StarkOperator):
    """Circle-STARK engine in reference-interop mode ("stark-stwo") on
    `device` (default "cuda"): proofs byte-identical to the stwo prover's
    for the same inputs (stark/stwo_compat/prover.py), which draws no
    randomness. The envelope has the reference's keys {success, blocks,
    algorithm, protocol: "stwo", proof (base64 bincode), proof_size_bytes}.
    chacha20 only, as in the reference."""

    ALGORITHMS = ("chacha20",)

    def __init__(self, algorithm: str, device=None):
        if algorithm not in self.ALGORITHMS:
            raise ValueError(f"the stark-stwo engine proves chacha20 only, "
                             f"not {algorithm!r}")
        super().__init__(algorithm, device=device)

    def prove(self, wi: ZKProofInput, rng=None) -> dict:
        import base64
        from .stark.stwo_compat.prover import prove_stream_bytes
        if rng is not None:
            raise ValueError("the stark-stwo engine takes no rng: its proofs "
                             "are a function of the inputs")
        nonce, counter0 = self._check_blocks(wi.blocks)
        timings = {}
        raw = prove_stream_bytes(wi.key, nonce, counter0, wi.plaintext,
                                 wi.ciphertext, device=self.device,
                                 timings=timings)
        self.timings = timings
        return {"success": True,
                "blocks": len(wi.plaintext) // 64,
                "algorithm": "chacha20",
                "protocol": "stwo",
                "proof": base64.b64encode(raw).decode(),
                "proof_size_bytes": len(raw)}

    @staticmethod
    def proof_bytes(proof_data: dict) -> bytes:
        """The bincode bytes of an envelope; ValueError if its base64 text
        passes the reference's 8 MB cap (wasm_api.rs:617), before decoding."""
        import base64
        from .interop.bincode import _MAX_PROOF_BYTES
        b64 = proof_data["proof"]
        if len(b64) > _MAX_PROOF_BYTES:
            raise ValueError("proof exceeds the 8 MB cap")
        return base64.b64decode(b64)

    def verify(self, public_bits: list, proof_data: dict) -> bool:
        """Verify on the host (stark/stwo_compat/verifier.py) against the
        statement decoded from public_bits. Any exception gives False."""
        from .stark.stwo_compat.verifier import verify_stream_proof_bytes
        try:
            inputs = self._public_inputs(public_bits)
            if inputs is None:
                return False
            nonce, counter0, pt, ct = inputs
            return verify_stream_proof_bytes(self.proof_bytes(proof_data),
                                             nonce, counter0, pt, ct)
        except Exception:
            return False


def make_operator(algorithm: str, engine: str, device=None):
    if engine == "groth16":
        return Groth16Operator(algorithm, device=device)
    if engine == "stark":
        return StarkOperator(algorithm, device=device)
    if engine == "stark-stwo":
        return StwoCompatOperator(algorithm, device=device)
    raise ValueError(f"unknown engine {engine!r} (available: groth16, stark, "
                     "stark-stwo)")

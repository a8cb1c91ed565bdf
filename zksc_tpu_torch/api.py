"""Public proving API: generate_proof(s) / verify_proof.

Ported from the JAX package's ``api.py`` for the six statements (chacha20,
aes-128-ctr, aes-256-ctr and their ``-toprf`` variants) under the Groth16
engine, chacha20, aes-128-ctr and aes-256-ctr under the "stark" engine
(``engine="stark"``), and chacha20 under "stark-stwo" (``engine=
"stark-stwo"``: byte-identical stwo proofs): chunk the ciphertext into cipher blocks, derive
per-block counters from byte offsets, pad to the fixed circuit chunk size,
decrypt locally to obtain the expected plaintext (the witness "out"),
dispatch to the engine operator, wrap the proof envelope {algorithm,
proofData, plaintext}. A
``-toprf`` proof keeps the plaintext private: its envelope carries none, and
the verifier takes the TOPRF public signals instead.

As in the reference, ``verify_proof`` defaults to ``engine="groth16"``: a
stark or stwo envelope verifies only with its engine passed and gives False
under the default.

Every entry point takes ``device=`` and runs on the GPU ("cuda") unless the
caller asks for the CPU; with no CUDA present and no explicit
``device="cpu"`` it raises.
"""
from __future__ import annotations

import json
import struct
from dataclasses import dataclass

from .config import CONFIG, get_counter_for_byte_offset
from .device import resolve_device
from .ops import ciphers


@dataclass
class BlockInfo:
    nonce: bytes
    counter: int
    boundary: int | None = None    # actual data bytes in this block:
                                   # None=full block, 0=empty, n=n bytes


@dataclass
class TOPRFResponseSignals:
    """One threshold server's response (mirror of the reference's
    ZKTOPRFResponsePublicSignals, js/src/types.ts:140-151)."""
    index: int                     # share index (1-based)
    public_key: tuple              # share public key (x, y) on BabyJubJub
    evaluated: tuple               # [sk_i]masked point (x, y)
    c: int                         # DLEQ challenge
    r: int                         # DLEQ response


@dataclass
class ZKTOPRFPublicSignals:
    """TOPRF public parameters for an OPRF proof (mirror of
    js/src/types.ts:153-159)."""
    locations: list                # [(pos, len)] byte ranges of secret data
    domain_separator: bytes
    output: int                    # TOPRF output (field element)
    responses: list                # [TOPRFResponseSignals] * threshold


@dataclass
class ZKProofInput:
    algorithm: str
    key: bytes
    blocks: list                   # [BlockInfo] per cipher block in the chunk
    ciphertext: bytes              # padded to chunk size
    plaintext: bytes               # padded to chunk size (expected output)
    data_len: int                  # unpadded ciphertext length
    toprf: ZKTOPRFPublicSignals | None = None
    mask: int | None = None        # OPRF blinding mask (private, toprf only)


@dataclass
class ProofEnvelope:
    algorithm: str
    proof_data: dict
    plaintext: bytes               # full padded chunk; the caller slices
    data_len: int = 0              # to data_len for the useful plaintext

    def to_json(self) -> str:
        return json.dumps({
            "algorithm": self.algorithm,
            "proofData": self.proof_data,
            "plaintext": self.plaintext.hex(),
            "dataLen": self.data_len,
        })

    @classmethod
    def from_json(cls, s: str) -> "ProofEnvelope":
        d = json.loads(s)
        return cls(d["algorithm"], d["proofData"],
                   bytes.fromhex(d["plaintext"]),
                   d.get("dataLen", len(d["plaintext"]) // 2))


PORTED_ALGORITHMS = ("chacha20", "aes-128-ctr", "aes-256-ctr",
                     "chacha20-toprf", "aes-128-ctr-toprf",
                     "aes-256-ctr-toprf")


def _check_algorithm(algorithm: str):
    if algorithm not in PORTED_ALGORITHMS:
        raise ValueError(f"algorithm {algorithm!r} is not ported yet "
                         f"({', '.join(PORTED_ALGORITHMS)})")


def _decrypt(algorithm: str, key: bytes, nonce: bytes, counter: int,
             data: bytes) -> bytes:
    if algorithm.startswith("chacha20"):
        return ciphers.chacha20_encrypt(key, nonce, counter, data)
    return ciphers.aes_ctr_encrypt(key, nonce, counter, data)


def _pad_with_boundaries(data: bytes, boundaries: list, block_size: int,
                         n_blocks: int) -> bytes:
    """Scatter an unpadded logical stream into physical block positions
    (block b holds boundaries[b] real bytes at its physical start,
    zero-padded to block_size)."""
    total = block_size * n_blocks
    actual = sum(boundaries)
    if len(data) == total:
        return data                     # already physically padded
    if len(data) != actual:
        raise ValueError(
            f"input length must be {total} (padded) or {actual} (unpadded): "
            f"{len(data)}")
    out = bytearray(total)
    src = 0
    for b in range(n_blocks):
        n = boundaries[b]
        out[b * block_size: b * block_size + n] = data[src: src + n]
        src += n
    return bytes(out)


def generate_zk_witness(algorithm: str, key: bytes, ciphertext: bytes,
                        iv: bytes, offset_bytes: int = 0,
                        boundaries: list | None = None,
                        toprf: ZKTOPRFPublicSignals | None = None,
                        mask: int | None = None) -> ZKProofInput:
    """Build the engine-neutral witness input for one chunk.

    ciphertext: at most one chunk of data starting at offset_bytes within the
    full stream (offset must be block-aligned); iv: the 12-byte nonce.
    boundaries: optional per-block real-byte counts (None entries = full);
    toprf + mask: present for the *-toprf statement variants (toprf signals
    on a plain algorithm name select its -toprf variant)."""
    if toprf is not None and not algorithm.endswith("-toprf"):
        algorithm = algorithm + "-toprf"
    _check_algorithm(algorithm)
    cfg = CONFIG[algorithm]
    if len(key) != cfg.key_size_bytes:
        raise ValueError(f"key must be {cfg.key_size_bytes} bytes")
    if len(iv) != cfg.iv_size_bytes:
        raise ValueError(f"iv must be {cfg.iv_size_bytes} bytes")
    if not ciphertext:
        raise ValueError("empty ciphertext")
    if algorithm.endswith("-toprf") and (toprf is None or mask is None):
        raise ValueError("toprf algorithms need toprf signals and a mask")
    start_counter = get_counter_for_byte_offset(algorithm, offset_bytes)
    n_blocks = cfg.blocks_per_chunk
    bs = cfg.block_size_bytes
    if boundaries is not None:
        if len(boundaries) != n_blocks:
            raise ValueError(f"need {n_blocks} boundaries")
        bnds = [bs if b is None else int(b) for b in boundaries]
        if any(b < 0 or b > bs for b in bnds):
            raise ValueError("boundary out of range")
        padded_ct = _pad_with_boundaries(ciphertext, bnds, bs, n_blocks)
        data_len = sum(bnds)
    else:
        if len(ciphertext) > cfg.chunk_size_bytes:
            raise ValueError(
                f"ciphertext longer than chunk ({cfg.chunk_size_bytes} bytes);"
                " split the stream into chunks and prove each separately")
        padded_ct = ciphertext + bytes(cfg.chunk_size_bytes - len(ciphertext))
        data_len = len(ciphertext)
    plaintext = _decrypt(algorithm, key, iv, start_counter, padded_ct)
    blocks = [BlockInfo(nonce=iv, counter=start_counter + b,
                        boundary=(None if boundaries is None else bnds[b]))
              for b in range(n_blocks)]
    return ZKProofInput(algorithm=algorithm, key=key, blocks=blocks,
                        ciphertext=padded_ct, plaintext=plaintext,
                        data_len=data_len, toprf=toprf, mask=mask)


def get_public_signals(algorithm: str, ciphertext: bytes, iv: bytes,
                       plaintext: bytes, offset_bytes: int = 0) -> list:
    """Public signal bit-vector in circuit order (verifier side): for each
    block [counter bits, nonce bits, in bits, out bits]."""
    from .r1cs.circuits.chacha20 import bytes_to_bits
    _check_algorithm(algorithm)
    cfg = CONFIG[algorithm]
    if len(ciphertext) > cfg.chunk_size_bytes:
        raise ValueError("ciphertext longer than one chunk")
    if len(plaintext) != cfg.chunk_size_bytes:
        raise ValueError("plaintext must be the full padded chunk")
    start_counter = get_counter_for_byte_offset(algorithm, offset_bytes)
    padded_ct = ciphertext + bytes(cfg.chunk_size_bytes - len(ciphertext))
    sig = []
    bs = cfg.block_size_bytes
    for b in range(cfg.blocks_per_chunk):
        sig += bytes_to_bits(struct.pack("<I", start_counter + b))
        sig += bytes_to_bits(iv)
        sig += bytes_to_bits(padded_ct[b * bs:(b + 1) * bs])
        sig += bytes_to_bits(plaintext[b * bs:(b + 1) * bs])
    return sig


def get_public_signals_toprf(algorithm: str, ciphertext: bytes, iv: bytes,
                             toprf: ZKTOPRFPublicSignals,
                             offset_bytes: int = 0,
                             boundaries: list | None = None) -> list:
    """Public signal vector for the *-toprf circuits, in circuit order:
    per block [counter bits, nonce bits, in bits], then bitmask bits, len,
    then the TOPRF parameters (domain, responses, Lagrange coefficients,
    share public keys, DLEQ c/r, output). Coefficients are recomputed from
    the response indices, as the reference verifier does
    (gnark/libraries/verifier/impl/verifiers.go toprf path)."""
    from .oprf.locations import compute_bitmask
    from .oprf.oprf import lagrange_coeff
    from .r1cs.circuits.chacha20 import bytes_to_bits
    if not algorithm.endswith("-toprf"):
        algorithm = algorithm + "-toprf"
    cfg = CONFIG[algorithm]
    bs = cfg.block_size_bytes
    n_blocks = cfg.blocks_per_chunk
    bnds = ([bs] * n_blocks if boundaries is None
            else [bs if b is None else int(b) for b in boundaries])
    padded_ct = _pad_with_boundaries(ciphertext, bnds, bs, n_blocks)
    start_counter = get_counter_for_byte_offset(algorithm, offset_bytes)
    sig = []
    for b in range(n_blocks):
        sig += bytes_to_bits(struct.pack("<I", start_counter + b))
        sig += bytes_to_bits(iv)
        sig += bytes_to_bits(padded_ct[b * bs:(b + 1) * bs])
    total_bits = 8 * bs * n_blocks
    sig += compute_bitmask(total_bits, toprf.locations, bnds, bs)
    sig.append(sum(l[1] if isinstance(l, tuple) else l.length
                   for l in toprf.locations))
    sig.append(int.from_bytes(toprf.domain_separator, "big"))
    indices = [r.index for r in toprf.responses]
    for r in toprf.responses:
        sig += [int(r.evaluated[0]), int(r.evaluated[1])]
    for r in toprf.responses:
        sig.append(lagrange_coeff(indices, r.index))
    for r in toprf.responses:
        sig += [int(r.public_key[0]), int(r.public_key[1])]
    for r in toprf.responses:
        sig.append(int(r.c))
    for r in toprf.responses:
        sig.append(int(r.r))
    sig.append(int(toprf.output))
    return sig


_OPERATORS = {}


def get_operator(algorithm: str, engine: str = "groth16", device=None):
    dev = resolve_device(device)
    key = (algorithm, engine, str(dev))
    if key not in _OPERATORS:
        from .operators import make_operator
        _OPERATORS[key] = make_operator(algorithm, engine, device=dev)
    return _OPERATORS[key]


def generate_proof(algorithm: str, key: bytes, ciphertext: bytes, iv: bytes,
                   offset_bytes: int = 0, engine: str = "groth16",
                   boundaries: list | None = None,
                   toprf: ZKTOPRFPublicSignals | None = None,
                   mask: int | None = None, device=None,
                   rng=None) -> ProofEnvelope:
    """Prove knowledge of `key` s.t. ciphertext decrypts to the returned
    plaintext. One chunk per call. With toprf+mask, proves the *-toprf
    statement instead: the plaintext stays private and the envelope carries
    no plaintext (reference provers.go returns output=nil for OPRF proofs).
    rng: optional callable () -> int for the Groth16 proof blinding
    (default: a cryptographically secure source; the stark engine takes
    none)."""
    dev = resolve_device(device)
    witness_input = generate_zk_witness(algorithm, key, ciphertext, iv,
                                        offset_bytes, boundaries=boundaries,
                                        toprf=toprf, mask=mask)
    operator = get_operator(witness_input.algorithm, engine, dev)
    proof_data = operator.prove(witness_input, rng)
    hide = witness_input.algorithm.endswith("-toprf")
    return ProofEnvelope(algorithm=witness_input.algorithm,
                         proof_data=proof_data,
                         plaintext=b"" if hide else witness_input.plaintext,
                         data_len=witness_input.data_len)


def get_algorithms_info(engine: str = "groth16") -> dict:
    """Circuit metadata per supported algorithm (mirror of the reference's
    get_circuits_info, stwo wasm_api.rs:994-1008): constraint/wire counts,
    NTT domain, chunk geometry, and the pinned circuit digest. Compiles
    every circuit on the host; nothing runs on a device."""
    from .operators import CircuitSpec
    info = {}
    for alg, cfg in CONFIG.items():
        cs = CircuitSpec(alg).cs
        info[alg] = {
            "engine": engine,
            "n_constraints": cs.n_constraints,
            "n_wires": cs.n_wires,
            "n_public": cs.n_public,
            "domain_n": max(4, 1 << (cs.n_constraints - 1).bit_length()),
            "chunk_size_bytes": cfg.chunk_size_bytes,
            "blocks_per_chunk": cfg.blocks_per_chunk,
            "digest": cs.digest(),
        }
    return info


def generate_proofs(algorithm: str, requests: list, engine: str = "groth16",
                    device=None, rng=None) -> list:
    """Batch variant of generate_proof. requests: list of dicts with keys
    {key, ciphertext, iv, offset_bytes?}; proves all chunks in one device
    pass."""
    dev = resolve_device(device)
    wis = [generate_zk_witness(algorithm, r["key"], r["ciphertext"], r["iv"],
                               r.get("offset_bytes", 0)) for r in requests]
    operator = get_operator(algorithm, engine, dev)
    datas = operator.prove_batch(wis, rng)
    return [ProofEnvelope(algorithm=algorithm, proof_data=d,
                          plaintext=wi.plaintext, data_len=wi.data_len)
            for d, wi in zip(datas, wis)]


def verify_proof(proof: ProofEnvelope, ciphertext: bytes, iv: bytes,
                 offset_bytes: int = 0, engine: str = "groth16",
                 toprf: ZKTOPRFPublicSignals | None = None,
                 boundaries: list | None = None, device=None) -> bool:
    """Verify a proof envelope against public data (host pairing check, or
    the STARK verifier with engine="stark": the engine is not read from the
    envelope). For *-toprf proofs pass the TOPRF public signals (and boundaries if the
    stream had partial blocks) instead of relying on the envelope plaintext."""
    dev = resolve_device(device)
    operator = get_operator(proof.algorithm, engine, dev)
    if proof.algorithm.endswith("-toprf"):
        if toprf is None:
            return False
        try:
            pub = get_public_signals_toprf(proof.algorithm, ciphertext, iv,
                                           toprf, offset_bytes, boundaries)
        except (ValueError, KeyError):
            return False
    else:
        if len(proof.plaintext) != CONFIG[proof.algorithm].chunk_size_bytes:
            return False
        pub = get_public_signals(proof.algorithm, ciphertext, iv,
                                 proof.plaintext, offset_bytes)
    return operator.verify(pub, proof.proof_data)

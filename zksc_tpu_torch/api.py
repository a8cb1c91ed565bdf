"""Public proving API: generate_proof(s) / verify_proof.

Ported from the JAX package's ``api.py`` for the chacha20, aes-128-ctr and
aes-256-ctr statements under the Groth16 engine: chunk the ciphertext into
cipher blocks, derive per-block counters from byte offsets, pad to the fixed
circuit chunk size, decrypt locally to obtain the expected plaintext (the
witness "out"), dispatch to the engine operator, wrap the proof envelope
{algorithm, proofData, plaintext}.

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
class ZKProofInput:
    algorithm: str
    key: bytes
    blocks: list                   # [BlockInfo] per cipher block in the chunk
    ciphertext: bytes              # padded to chunk size
    plaintext: bytes               # padded to chunk size (expected output)
    data_len: int                  # unpadded ciphertext length


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


PORTED_ALGORITHMS = ("chacha20", "aes-128-ctr", "aes-256-ctr")


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
                        boundaries: list | None = None) -> ZKProofInput:
    """Build the engine-neutral witness input for one chunk.

    ciphertext: at most one chunk of data starting at offset_bytes within the
    full stream (offset must be block-aligned); iv: the 12-byte nonce.
    boundaries: optional per-block real-byte counts (None entries = full)."""
    _check_algorithm(algorithm)
    cfg = CONFIG[algorithm]
    if len(key) != cfg.key_size_bytes:
        raise ValueError(f"key must be {cfg.key_size_bytes} bytes")
    if len(iv) != cfg.iv_size_bytes:
        raise ValueError(f"iv must be {cfg.iv_size_bytes} bytes")
    if not ciphertext:
        raise ValueError("empty ciphertext")
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
                        data_len=data_len)


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
                   boundaries: list | None = None, device=None,
                   rng=None) -> ProofEnvelope:
    """Prove knowledge of `key` s.t. ciphertext decrypts to the returned
    plaintext. One chunk per call. rng: optional callable () -> int for the
    proof blinding (default: a cryptographically secure source)."""
    dev = resolve_device(device)
    witness_input = generate_zk_witness(algorithm, key, ciphertext, iv,
                                        offset_bytes, boundaries=boundaries)
    operator = get_operator(witness_input.algorithm, engine, dev)
    proof_data = operator.prove(witness_input, rng)
    return ProofEnvelope(algorithm=witness_input.algorithm,
                         proof_data=proof_data,
                         plaintext=witness_input.plaintext,
                         data_len=witness_input.data_len)


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
                 device=None) -> bool:
    """Verify a proof envelope against public data (host pairing check)."""
    dev = resolve_device(device)
    operator = get_operator(proof.algorithm, engine, dev)
    if len(proof.plaintext) != CONFIG[proof.algorithm].chunk_size_bytes:
        return False
    pub = get_public_signals(proof.algorithm, ciphertext, iv,
                             proof.plaintext, offset_bytes)
    return operator.verify(pub, proof.proof_data)

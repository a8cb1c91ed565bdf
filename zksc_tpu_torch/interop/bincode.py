"""bincode v1 codec for the Circle-STARK proof envelopes.

Ported from the JAX package's ``interop/bincode.py``: the Writer/Reader, the
FRI and row codecs, the ChaCha20 stream proof and the AES-CTR proof, with
their envelopes.

The reference's stwo engine ships proofs as `base64(bincode::serialize(proof))`
(stwo/src/wasm_api.rs:588-601, decoded under an 8 MB DoS cap at :27,617-639).
This module reproduces that wire discipline for OUR proof structs: bincode v1
default options — fixed-width little-endian integers, u64 length prefixes for
sequences/byte-strings, struct fields in declaration order, fixed-size arrays
raw (no prefix) — exactly what a serde derive over equivalent Rust structs
would produce.

Struct schemas (field order = encode order):

  StreamStatement { log_rows: u32, n_blocks: u32, nonce: Vec<u8>,
                    counter0: u32, pt_hash: [u8;32], ct_hash: [u8;32] }
  FriLayerOpening { value: [u32;4], pair_value: [u32;4],
                    path: Vec<[u8;32]>, pair_path: Vec<[u8;32]> }
  FriProof        { layer_roots: Vec<[u8;32]>, last_value: [u32;4],
                    pow_nonce: u64, log_n: u32, log_blowup: u32,
                    openings: Vec<Vec<FriLayerOpening>> }
  TraceOpening    { values: Vec<u32>, path: Vec<[u8;32]> }
  StreamProof     { stmt, trace_root: [u8;32], fri, openings: Vec<TraceOpening> }
  AesStatement    { key_size: u32, log_rows: u32, n_blocks: u32,
                    nonce: Vec<u8>, counter0: u32, pt_hash: [u8;32],
                    ct_hash: [u8;32] }
  RowOpening      { values: Vec<u32>, path: Vec<[u8;32]> }
  AesProof        { stmt, root1: [u8;32], root2: [u8;32], fri,
                    openings1, openings1s, openings2, openings2s:
                    Vec<RowOpening> }

The JSON envelope carrying the payload uses the reference's keys
{"success", "blocks", "algorithm", "proof": base64, "proof_size_bytes"}
(stwo wasm_api.rs:595-601), plus a "protocol" key of our own for dispatch.
Like the reference, the 8 MB DoS cap is enforced on the *base64* length
(wasm_api.rs:617) before decoding.
"""
from __future__ import annotations

import struct

import numpy as np

_MAX_PROOF_BYTES = 8 * 1024 * 1024      # stwo parity: wasm_api.rs:27


class Writer:
    def __init__(self):
        self._parts = []

    def u8(self, v: int):
        self._parts.append(struct.pack("<B", v))

    def u32(self, v: int):
        self._parts.append(struct.pack("<I", v))

    def u64(self, v: int):
        self._parts.append(struct.pack("<Q", v))

    def raw(self, b: bytes):
        self._parts.append(bytes(b))

    def bytes_(self, b: bytes):
        """Vec<u8>: u64 length + raw."""
        self.u64(len(b))
        self.raw(b)

    def digest(self, b: bytes):
        """[u8;32]: fixed array, no prefix."""
        if len(b) != 32:
            raise ValueError(f"digest must be 32 bytes, got {len(b)}")
        self.raw(b)

    def digests(self, lst):
        self.u64(len(lst))
        for d in lst:
            self.digest(d)

    def u32x4(self, t):
        if len(t) != 4:
            raise ValueError("qm31 value must have 4 components")
        for v in t:
            self.u32(int(v))

    def vec_u32(self, arr):
        a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
        self.u64(a.size)
        self.raw(a.tobytes())

    def getvalue(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    def __init__(self, data: bytes):
        if len(data) > _MAX_PROOF_BYTES:
            raise ValueError("proof exceeds the 8 MB cap")
        self._d = data
        self._o = 0

    def _take(self, n: int) -> bytes:
        if self._o + n > len(self._d):
            raise ValueError("truncated bincode payload")
        b = self._d[self._o:self._o + n]
        self._o += n
        return b

    def u8(self) -> int:
        return self._take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def _len(self) -> int:
        n = self.u64()
        if n > _MAX_PROOF_BYTES:
            raise ValueError("length prefix exceeds the payload cap")
        return n

    def bytes_(self) -> bytes:
        return self._take(self._len())

    def digest(self) -> bytes:
        return self._take(32)

    def digests(self) -> list:
        return [self.digest() for _ in range(self._len())]

    def u32x4(self) -> tuple:
        return tuple(self.u32() for _ in range(4))

    def vec_u32(self) -> np.ndarray:
        n = self._len()
        return np.frombuffer(self._take(4 * n), dtype="<u4").astype(np.uint32)

    def done(self):
        if self._o != len(self._d):
            raise ValueError("trailing bytes after bincode payload")


# ---- FRI ----

def _write_fri(w: Writer, fri):
    w.digests(fri.layer_roots)
    w.u32x4(fri.last_value)
    w.u64(fri.pow_nonce)
    w.u32(fri.log_n)
    w.u32(fri.log_blowup)
    w.u64(len(fri.openings))
    for per_q in fri.openings:
        w.u64(len(per_q))
        for o in per_q:
            w.u32x4(o.value)
            w.u32x4(o.pair_value)
            w.digests(o.path)
            w.digests(o.pair_path)


def _read_fri(r: Reader):
    from ..stark.fri import FriLayerOpening, FriProof
    roots = r.digests()
    last = r.u32x4()
    pow_nonce = r.u64()
    log_n = r.u32()
    log_blowup = r.u32()
    openings = []
    for _ in range(r._len()):
        per_q = []
        for _ in range(r._len()):
            per_q.append(FriLayerOpening(
                value=r.u32x4(), pair_value=r.u32x4(),
                path=r.digests(), pair_path=r.digests()))
        openings.append(per_q)
    return FriProof(layer_roots=roots, last_value=last, pow_nonce=pow_nonce,
                    openings=openings, log_n=log_n, log_blowup=log_blowup)


def _write_rows(w: Writer, rows):
    w.u64(len(rows))
    for o in rows:
        w.vec_u32(o.values)
        w.digests(o.path)


def _read_rows(r: Reader, cls):
    return [cls(values=r.vec_u32(), path=r.digests())
            for _ in range(r._len())]


# ---- ChaCha stream proof ----

def encode_stream_proof(proof) -> bytes:
    w = Writer()
    s = proof.stmt
    w.u32(s.log_rows)
    w.u32(s.n_blocks)
    w.bytes_(s.nonce)
    w.u32(s.counter0)
    w.digest(s.pt_hash)
    w.digest(s.ct_hash)
    w.digest(proof.trace_root)
    _write_fri(w, proof.fri)
    _write_rows(w, proof.openings)
    return w.getvalue()


def decode_stream_proof(data: bytes):
    from ..stark.prover import StreamProof, StreamStatement, TraceOpening
    r = Reader(data)
    stmt = StreamStatement(
        log_rows=r.u32(), n_blocks=r.u32(), nonce=r.bytes_(),
        counter0=r.u32(), pt_hash=r.digest(), ct_hash=r.digest())
    root = r.digest()
    fri = _read_fri(r)
    openings = _read_rows(r, TraceOpening)
    r.done()
    return StreamProof(stmt=stmt, trace_root=root, fri=fri,
                       openings=openings)


# ---- AES-CTR proof ----

def encode_aes_proof(proof) -> bytes:
    w = Writer()
    s = proof.stmt
    w.u32(s.key_size)
    w.u32(s.log_rows)
    w.u32(s.n_blocks)
    w.bytes_(s.nonce)
    w.u32(s.counter0)
    w.digest(s.pt_hash)
    w.digest(s.ct_hash)
    w.digest(proof.root1)
    w.digest(proof.root2)
    _write_fri(w, proof.fri)
    for rows in (proof.openings1, proof.openings1s,
                 proof.openings2, proof.openings2s):
        _write_rows(w, rows)
    return w.getvalue()


def decode_aes_proof(data: bytes):
    from ..stark.aes_prover import AesProof, AesStatement, RowOpening
    r = Reader(data)
    stmt = AesStatement(
        key_size=r.u32(), log_rows=r.u32(), n_blocks=r.u32(),
        nonce=r.bytes_(), counter0=r.u32(), pt_hash=r.digest(),
        ct_hash=r.digest())
    root1, root2 = r.digest(), r.digest()
    fri = _read_fri(r)
    rows = [_read_rows(r, RowOpening) for _ in range(4)]
    r.done()
    return AesProof(stmt=stmt, root1=root1, root2=root2, fri=fri,
                    openings1=rows[0], openings1s=rows[1],
                    openings2=rows[2], openings2s=rows[3])


# ---- base64 envelopes (the reference's {proof, proof_size_bytes} shape) ----

def stream_proof_envelope(proof) -> dict:
    import base64
    raw = encode_stream_proof(proof)
    return {"success": True, "blocks": int(proof.stmt.n_blocks),
            "algorithm": "chacha20", "protocol": "circle-stark",
            "proof": base64.b64encode(raw).decode(),
            "proof_size_bytes": len(raw)}


def aes_proof_envelope(proof) -> dict:
    import base64
    raw = encode_aes_proof(proof)
    alg = "aes-128-ctr" if proof.stmt.key_size == 16 else "aes-256-ctr"
    return {"success": True, "blocks": int(proof.stmt.n_blocks),
            "algorithm": alg, "protocol": "circle-stark-aes",
            "proof": base64.b64encode(raw).decode(),
            "proof_size_bytes": len(raw)}


def proof_from_envelope(d: dict):
    """Decode a reference-keyed envelope ({"algorithm", "proof": base64, ...})
    to the proof object. The 8 MB cap applies to the base64 text, matching
    the reference (wasm_api.rs:617)."""
    import base64
    b64 = d["proof"]
    if len(b64) > _MAX_PROOF_BYTES:
        raise ValueError("proof exceeds the 8 MB cap")
    raw = base64.b64decode(b64)
    if (d.get("protocol") == "circle-stark-aes"
            or str(d.get("algorithm", "")).startswith("aes")):
        return decode_aes_proof(raw)
    return decode_stream_proof(raw)

"""bincode v1 codec for stwo's `StreamProof<Blake2sMerkleHasher>`.

Copied from the JAX package's ``stark/stwo_compat/codec.py``.

Schema established byte-by-byte against reference-generated proofs
(stwo @ f117d48, s2circuits wasm_api.rs `generate_chacha20_proof`):

  StreamProof {
    stmt: StreamStatement {
      log_size: u32,
      public_inputs: ChaChaPublicInputs {
        nonce: [u8;12], counter: u32,
        plaintext_hash: [u8;32], ciphertext_hash: [u8;32],
      },
    },
    stark_proof: StarkProof {
      config: PcsConfig {
        pow_bits: u32,
        fri_config: FriConfig {
          log_blowup_factor: u32,
          log_last_layer_degree_bound: u32,
          n_queries: u64,               # usize
        },
      },
      u32 = 1, u8 = 0,                  # observed constants (see NOTES.md)
      commitments: Vec<[u8;32]>,                  # one root per tree
      sampled_values: Vec<Vec<Vec<QM31>>>,        # tree -> col -> samples
      decommitments: Vec<Vec<[u8;32]>>,           # tree -> hash witness
      queried_values: Vec<Vec<Vec<u32 (M31)>>>,   # tree -> col -> queries
      proof_of_work: u64,
      fri_proof: FriProof {
        first_layer: FriLayerProof,
        inner_layers: Vec<FriLayerProof>,
        last_layer_poly: LinePoly { coeffs: Vec<QM31>, log_size: u32 },
      },
    },
  }
  FriLayerProof {
    fri_witness: Vec<QM31>,
    decommitment_hash_witness: Vec<[u8;32]>,
    commitment: [u8;32],
  }
  QM31 = 4 x u32 little-endian (a.0, a.1, b.0, b.1)

bincode v1 defaults: little-endian fixed-width ints, u64 length prefixes,
struct fields in declaration order, fixed arrays raw.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

_MAX = 100_000_000


@dataclass
class FriLayer:
    fri_witness: list            # list[tuple[int,int,int,int]]
    hash_witness: list           # list[bytes32]
    commitment: bytes


@dataclass
class StwoStreamProof:
    # statement
    log_size: int
    nonce: bytes
    counter: int
    pt_hash: bytes
    ct_hash: bytes
    # config
    pow_bits: int
    log_blowup: int
    log_last_layer: int
    n_queries: int
    # observed constants between config and commitments
    const_u32: int = 1
    const_u8: int = 0
    # proof body
    commitments: list = field(default_factory=list)
    sampled_values: list = field(default_factory=list)   # [tree][col][sample]
    decommitments: list = field(default_factory=list)    # [tree][hash]
    queried_values: list = field(default_factory=list)   # [tree][col][query]
    proof_of_work: int = 0
    first_layer: FriLayer | None = None
    inner_layers: list = field(default_factory=list)
    last_layer_coeffs: list = field(default_factory=list)
    last_layer_log_size: int = 0


class _R:
    def __init__(self, b: bytes):
        self.b = b
        self.o = 0

    def u8(self):
        v = self.b[self.o]
        self.o += 1
        return v

    def u32(self):
        v, = struct.unpack_from("<I", self.b, self.o)
        self.o += 4
        return v

    def u64(self):
        v, = struct.unpack_from("<Q", self.b, self.o)
        self.o += 8
        return v

    def take(self, n):
        v = self.b[self.o:self.o + n]
        if len(v) != n:
            raise ValueError("truncated proof")
        self.o += n
        return v

    def qm31(self):
        v = struct.unpack_from("<4I", self.b, self.o)
        self.o += 16
        return v

    def vec(self, f, cap=_MAX):
        n = self.u64()
        if n > cap:
            raise ValueError(f"implausible length {n}")
        return [f() for _ in range(n)]


def decode_stream_proof(raw: bytes) -> StwoStreamProof:
    r = _R(raw)
    p = StwoStreamProof(
        log_size=r.u32(), nonce=r.take(12), counter=r.u32(),
        pt_hash=r.take(32), ct_hash=r.take(32),
        pow_bits=r.u32(), log_blowup=r.u32(), log_last_layer=r.u32(),
        n_queries=r.u64())
    p.const_u32 = r.u32()
    p.const_u8 = r.u8()
    p.commitments = r.vec(lambda: r.take(32), 64)
    p.sampled_values = r.vec(
        lambda: r.vec(lambda: r.vec(r.qm31, 1024), _MAX), 64)
    p.decommitments = r.vec(lambda: r.vec(lambda: r.take(32), _MAX), 64)
    p.queried_values = r.vec(
        lambda: r.vec(lambda: r.vec(r.u32, 100_000), _MAX), 64)
    p.proof_of_work = r.u64()

    def layer():
        return FriLayer(fri_witness=r.vec(r.qm31),
                        hash_witness=r.vec(lambda: r.take(32), _MAX),
                        commitment=r.take(32))
    p.first_layer = layer()
    p.inner_layers = r.vec(layer, 64)
    p.last_layer_coeffs = r.vec(r.qm31, 1 << 20)
    p.last_layer_log_size = r.u32()
    if r.o != len(raw):
        raise ValueError(f"trailing bytes: {len(raw) - r.o}")
    return p


class _W:
    def __init__(self):
        self.parts = []

    def u8(self, v):
        self.parts.append(struct.pack("<B", v))

    def u32(self, v):
        self.parts.append(struct.pack("<I", v))

    def u64(self, v):
        self.parts.append(struct.pack("<Q", v))

    def raw(self, b):
        self.parts.append(bytes(b))

    def qm31(self, q):
        self.parts.append(struct.pack("<4I", *q))

    def vec(self, items, f):
        self.u64(len(items))
        for it in items:
            f(it)

    def out(self):
        return b"".join(self.parts)


def encode_stream_proof(p: StwoStreamProof) -> bytes:
    w = _W()
    w.u32(p.log_size)
    w.raw(p.nonce)
    w.u32(p.counter)
    w.raw(p.pt_hash)
    w.raw(p.ct_hash)
    w.u32(p.pow_bits)
    w.u32(p.log_blowup)
    w.u32(p.log_last_layer)
    w.u64(p.n_queries)
    w.u32(p.const_u32)
    w.u8(p.const_u8)
    w.vec(p.commitments, w.raw)
    w.vec(p.sampled_values,
          lambda t: w.vec(t, lambda c: w.vec(c, w.qm31)))
    w.vec(p.decommitments, lambda t: w.vec(t, w.raw))
    w.vec(p.queried_values,
          lambda t: w.vec(t, lambda c: w.vec(c, w.u32)))
    w.u64(p.proof_of_work)

    def layer(l: FriLayer):
        w.vec(l.fri_witness, w.qm31)
        w.vec(l.hash_witness, w.raw)
        w.raw(l.commitment)
    layer(p.first_layer)
    w.vec(p.inner_layers, layer)
    w.vec(p.last_layer_coeffs, w.qm31)
    w.u32(p.last_layer_log_size)
    return w.out()

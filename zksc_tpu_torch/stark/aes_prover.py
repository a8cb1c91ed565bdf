"""Circle-STARK prover/verifier for the AES-CTR lookup AIR ("stark" engine).

Ported from the JAX package's ``stark/aes_prover.py``, with the same
constants, transcript, DoS checks and wire form (see stark/aes_air.py for
the AIR and the in-trace LogUp table).

Two-phase commitment (the LogUp interaction pattern):

  prove:  statement mix -> phase-1 commit (bit trace + multiplicity) ->
          draw z, alpha_lk -> phase-2 commit (lookup fractions f, table
          fraction g, cumulative column) -> draw constraint alpha ->
          composition (pointwise + sigma-shifted constraint groups) / V_N ->
          FRI. Both phases use blinded LDEs (zero knowledge as in
          stark/prover.py).
  verify: statement fast-fail -> channel replay -> verifier-evaluated public
          columns -> per-query ALI: openings of both trees at q AND sigma(q)
          must reproduce FRI layer 0 = C(q) / V_N(q).

Where the work runs: the circle FFTs (K7b) and the trees' leaves and large
node layers (K7a) as in stark/prover.py; the lookup denominators and their
QM31 inverses as PyTorch ops on the device, the table fraction g and the
cumulative column on the host (numpy, as the reference has them); the
composition through K7d on the card (``_composition_plain`` on the CPU).
The committed phase-1 columns and the public ones go through one batched
LDE. The reference materialises vals[:, sigma] (an R x M copy); K7d reads
vals[row, sigma(x)] in place, and the plain version gathers only the
shifted rows it needs. ``prove_aes_ctr`` takes its blinding bytes from
``rand_bytes`` (default ``secrets.token_bytes``), drawn in the reference's
order (phase 1, then phase 2, none for the public columns), so a test can
give both packages the same bytes and compare the envelopes byte for byte.
"""
from __future__ import annotations

import functools
import hashlib
import secrets
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import stark_kernels
from . import aes_air, merkle
from .channel import Channel
from .fri import FriContext, FriProof
from .m31 import P31, m31_add, m31_mul, m31_sub, qm31_inv, qm31_mul
from .prover import (
    FRI_LOG_BLOWUP, N_QUERIES, POW_BITS, ZK_COEFFS, _alpha_powers,
    _domain_params, _ffts, _host_weighted_sum, _lde, _stage, _vn_evals,
    _vn_inv_on,
)

MIN_LOG_ROWS = 8         # the S-box table lives in the first 256 rows
MAX_LOG_ROWS = 12        # DoS + memory bound (4096 blocks = 64 KiB / proof)
CHANNEL_SEED = b"zksc-tpu-stark-aes-v1"
PLAIN_ITEMS = 512        # items per step of _composition_plain (memory bound)


@dataclass
class AesStatement:
    key_size: int            # 16 or 32
    log_rows: int
    n_blocks: int
    nonce: bytes
    counter0: int
    pt_hash: bytes
    ct_hash: bytes

    def mix_into(self, ch: Channel):
        ch.mix_u64(self.key_size)
        ch.mix_u64(self.log_rows)
        ch.mix_u64(self.n_blocks)
        ch.mix_bytes(self.nonce)
        ch.mix_u64(self.counter0)
        ch.mix_bytes(self.pt_hash)
        ch.mix_bytes(self.ct_hash)


@dataclass
class RowOpening:
    values: np.ndarray
    path: list


@dataclass
class AesProof:
    stmt: AesStatement
    root1: bytes
    root2: bytes
    fri: FriProof
    openings1: list          # [per query] RowOpening of tree1 at q
    openings1s: list         # ... at sigma(q)
    openings2: list          # tree2 at q
    openings2s: list         # tree2 at sigma(q)

    def to_json_dict(self) -> dict:
        import base64
        b64 = lambda b: base64.b64encode(b).decode()

        def rows(ops):
            return [{"values": b64(np.ascontiguousarray(o.values).tobytes()),
                     "path": [b64(x) for x in o.path]} for o in ops]

        return {
            "protocol": "circle-stark-aes",
            "statement": {
                "keySize": self.stmt.key_size,
                "logRows": self.stmt.log_rows,
                "nBlocks": self.stmt.n_blocks,
                "nonce": b64(self.stmt.nonce),
                "counter": self.stmt.counter0,
                "ptHash": b64(self.stmt.pt_hash),
                "ctHash": b64(self.stmt.ct_hash),
            },
            "root1": b64(self.root1),
            "root2": b64(self.root2),
            "fri": {
                "roots": [b64(r) for r in self.fri.layer_roots],
                "last": list(self.fri.last_value),
                "pow": self.fri.pow_nonce,
                "logN": self.fri.log_n,
                "logBlowup": self.fri.log_blowup,
                "openings": [[{
                    "v": list(o.value), "pv": list(o.pair_value),
                    "p": [b64(x) for x in o.path],
                    "pp": [b64(x) for x in o.pair_path],
                } for o in per_q] for per_q in self.fri.openings],
            },
            "rows1": rows(self.openings1), "rows1s": rows(self.openings1s),
            "rows2": rows(self.openings2), "rows2s": rows(self.openings2s),
        }

    def to_envelope(self) -> dict:
        """Compact wire form: base64(bincode) payload (interop/bincode.py)."""
        from ..interop.bincode import aes_proof_envelope
        return aes_proof_envelope(self)

    @classmethod
    def from_json_dict(cls, d: dict) -> "AesProof":
        import base64
        from .fri import FriLayerOpening
        if "proof" in d:       # base64-bincode envelope
            from ..interop.bincode import decode_aes_proof
            return decode_aes_proof(base64.b64decode(d["proof"]))
        ub = base64.b64decode
        s = d["statement"]
        stmt = AesStatement(
            key_size=int(s["keySize"]), log_rows=int(s["logRows"]),
            n_blocks=int(s["nBlocks"]), nonce=ub(s["nonce"]),
            counter0=int(s["counter"]), pt_hash=ub(s["ptHash"]),
            ct_hash=ub(s["ctHash"]))
        f = d["fri"]
        fri = FriProof(
            layer_roots=[ub(r) for r in f["roots"]],
            last_value=tuple(int(x) for x in f["last"]),
            pow_nonce=int(f["pow"]), log_n=int(f["logN"]),
            log_blowup=int(f["logBlowup"]),
            openings=[[FriLayerOpening(
                value=tuple(int(x) for x in o["v"]),
                pair_value=tuple(int(x) for x in o["pv"]),
                path=[ub(x) for x in o["p"]],
                pair_path=[ub(x) for x in o["pp"]],
            ) for o in per_q] for per_q in f["openings"]])

        def rows(lst):
            return [RowOpening(
                values=np.frombuffer(ub(o["values"]), dtype=np.uint32),
                path=[ub(x) for x in o["path"]]) for o in lst]

        return cls(stmt=stmt, root1=ub(d["root1"]), root2=ub(d["root2"]),
                   fri=fri,
                   openings1=rows(d["rows1"]), openings1s=rows(d["rows1s"]),
                   openings2=rows(d["rows2"]), openings2s=rows(d["rows2s"]))


def n_constraints(key_size: int) -> int:
    n1, n2, g = aes_air.layout(key_size)
    return (len(g["bool"]) + len(g["const"]) + len(g["xor"]["R"])
            + len(g["mix"]["R"]) + 4 * len(g["lookup"]["U"]) + 4 + 4
            + len(g["eq"]["KS"]))


@functools.lru_cache(maxsize=8)
def _sigma_on(log_rows: int, device: torch.device) -> torch.Tensor:
    """sigma on the M-domain as an index map, int32 [M] on `device`."""
    n, m, _ = _domain_params(log_rows)
    return torch.from_numpy(aes_air.sigma_perm(m, m // n)).to(device)


@functools.lru_cache(maxsize=4)
def _groups_on(key_size: int, device: torch.device) -> tuple:
    """K7d's staging table of aes_air.layout(key_size) (aes_slice_table over
    aes_slices' bounds) on `device`, kept for the process's lifetime:
    (hdr, srows, n, max_row), aes_composition's `table`."""
    n1, n2, groups = aes_air.layout(key_size)
    idx, off, n, rows = stark_kernels.pack_aes_groups(groups)
    R = n1 + n2 + aes_air.N_PUB + 1
    if min(idx.min(), *rows) < 0 or max(idx.max(), *rows) >= R:
        raise ValueError("an index group reaches outside the value rows")
    hdr, srows = stark_kernels.aes_slice_table(idx, off, n, rows,
                                               stark_kernels.aes_slices(n))
    return (torch.from_numpy(hdr).to(device), torch.from_numpy(srows).to(device),
            n, int(srows.max()))


def _denominators(u, v, z4, a4) -> tuple:
    """The components of z - (u + alpha v): u, v int64 tensors of M31
    values, z4 / a4 the challenges' components (ints)."""
    av = [m31_mul(v, a4[c]) for c in range(4)]
    return (m31_sub(z4[0], m31_add(u, av[0])),) + tuple(
        m31_sub(z4[c], av[c]) for c in range(1, 4))


def _qm4_mul(a, b) -> tuple:
    """QM31 product of component 4-tuples (a + b i) + (c + d i) u."""
    (c0, c1), (c2, c3) = qm31_mul(((a[0], a[1]), (a[2], a[3])),
                                  ((b[0], b[1]), (b[2], b[3])))
    return c0, c1, c2, c3


def _interaction(lk_u: np.ndarray, lk_v: np.ndarray, mult: np.ndarray, z4, a4,
                 rows: int, device) -> np.ndarray:
    """Phase-2 trace: lookup fractions f_j = 1/(z - (u + alpha v)), table
    fraction g = m*tact/(z - (tval + alpha sval)), cumulative column.
    Returns uint32[4*(n_lk+2), rows] in F-major layout [f_j comps | g | cum].
    The denominators and their inverses (the lookups' and the table's, one
    batch) are PyTorch ops on `device`; g and cum are numpy on the host."""
    n_lk = lk_u.shape[0]
    r = np.arange(rows)
    tval = np.where(r < 256, r, 0)
    u = np.concatenate([lk_u, tval[None]]).astype(np.int64)
    v = np.concatenate([lk_v, aes_air.SBOX[tval][None]]).astype(np.int64)
    den = _denominators(torch.from_numpy(u).to(device),
                        torch.from_numpy(v).to(device), z4, a4)
    (i0, i1), (i2, i3) = qm31_inv(((den[0], den[1]), (den[2], den[3])))
    inv = torch.stack([i0, i1, i2, i3], dim=1).cpu().numpy().astype(np.uint64)
    f, tinv = inv[:n_lk], inv[n_lk]                # [n_lk, 4, rows], [4, rows]
    tact = (r < 256).astype(np.uint64)
    g = tinv * (mult.astype(np.uint64) * tact) % P31
    fsum = f.sum(axis=0) % P31
    F = (fsum + P31 - g) % P31
    cum = aes_air.cum_column(F.astype(np.uint32), rows)
    return np.concatenate([f.reshape(-1, rows), g, cum]).astype(np.uint32)


def _composition_plain(vals: torch.Tensor, perm: torch.Tensor, groups: dict,
                       z4, a4, weights: torch.Tensor,
                       vn_inv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K7d (aes_prover.py:234-295): vals int32 [R, M] (phase 1
    | phase 2 | public | zero), perm = sigma on the M-domain as an index map
    [M], groups as aes_air.layout gives them, z4 / a4 the LogUp challenges,
    weights [K, 4], vn_inv [M]. Returns Q = C(x) / V_N(x) as int32 [4, M].

    Constraint order (alpha powers): bool | const | xor | mix | lookup (4
    per instance, interleaved: row 4j + c) | table (4) | cum (4) | eq. The
    shifted values are gathered for the rows that need them, vals[rows][:,
    perm]; the sums run over PLAIN_ITEMS items at a time (exact mod p, so
    the reference's values)."""
    dev = vals.device
    M = vals.shape[1]
    perm = perm.to(device=dev, dtype=torch.int64)
    w_all = weights.to(device=dev, dtype=torch.int64)
    acc = torch.zeros((4, M), dtype=torch.int64, device=dev)
    k = 0

    def at(rows):
        idx = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=dev)
        return vals[idx].to(torch.int64)

    def sh(rows):
        return at(rows)[..., perm]

    def add(c):                                    # c [n, M], weight rows k..
        nonlocal k
        w = w_all[k:k + c.shape[0]]
        for q in range(4):
            acc[q] = m31_add(acc[q], m31_mul(w[:, q:q + 1], c).sum(0) % P31)
        k += c.shape[0]

    def steps(n):
        return [(lo, min(n, lo + PLAIN_ITEMS)) for lo in range(0, n, PLAIN_ITEMS)]

    def byte_val(refs8):                           # sum_i 2^i vals[refs8[:, i]]
        shift = torch.arange(8, device=dev).view(1, 8, 1)
        return (at(refs8) << shift).sum(1) % P31

    for lo, hi in steps(len(groups["bool"])):
        b = at(groups["bool"][lo:hi])
        add(m31_mul(b, m31_sub(1, b)))
    for lo, hi in steps(len(groups["const"])):
        r = groups["const"][lo:hi]
        add(m31_sub(sh(r), at(r)))
    x = groups["xor"]
    for lo, hi in steps(len(x["R"])):
        xa, xb = at(x["A"][lo:hi]), at(x["B"][lo:hi])
        add(m31_sub(m31_add(at(x["R"][lo:hi]), m31_mul(2, m31_mul(xa, xb))),
                    m31_add(xa, xb)))
    mx = groups["mix"]
    for lo, hi in steps(len(mx["R"])):
        s = at(mx["T"][lo:hi]).sum(1) % P31        # [n, 9, M] -> [n, M]
        dec = (at(mx["R"][lo:hi]) + 2 * at(mx["K0"][lo:hi])
               + 4 * at(mx["K1"][lo:hi]) + 8 * at(mx["K2"][lo:hi])) % P31
        add(m31_sub(s, dec))
    lk = groups["lookup"]
    for lo, hi in steps(len(lk["U"])):
        den = _denominators(byte_val(lk["U"][lo:hi]), byte_val(lk["V"][lo:hi]),
                            z4, a4)
        f = at(lk["F"][lo:hi])                     # [n, 4, M]
        prod = _qm4_mul(tuple(f[:, c] for c in range(4)), den)
        add(torch.stack([m31_sub(prod[0], 1), *prod[1:]], dim=1).reshape(-1, M))
    tb = groups["table"]
    tden = _denominators(at([tb["TVAL"]]), at([tb["SVAL"]]), z4, a4)
    gprod = _qm4_mul(tuple(at([tb["G"][c]]) for c in range(4)), tden)
    mt = m31_mul(at([tb["M"]]), at([tb["TACT"]]))
    add(torch.cat([m31_sub(gprod[0], mt), *gprod[1:]]))
    cum_cs = []
    for c in range(4):                             # cum(sx) - cum(x) - F(sx)
        fsum = sh(lk["F"][:, c]).sum(0, keepdim=True) % P31
        F_sh = m31_sub(fsum, sh([tb["G"][c]]))
        cum = groups["cum"][c]
        cum_cs.append(m31_sub(m31_sub(sh([cum]), at([cum])), F_sh))
    add(torch.cat(cum_cs))
    e = groups["eq"]
    for lo, hi in steps(len(e["KS"])):
        ks, pt = at(e["KS"][lo:hi]), at(e["PT"][lo:hi])
        add(m31_sub(m31_add(ks, pt),
                    m31_add(m31_mul(2, m31_mul(ks, pt)), at(e["CT"][lo:hi]))))
    return m31_mul(acc, vn_inv.to(device=dev, dtype=torch.int64)).to(torch.int32)


def _composition(vals: torch.Tensor, key_size: int, log_rows: int, z4, a4,
                 weights: np.ndarray) -> np.ndarray:
    """Q = C(x) / V_N(x) as uint32 [4, M]: K7d on the card, the plain
    version on the CPU."""
    dev = vals.device
    w = torch.from_numpy(weights.astype(np.int32)).to(dev)
    vn_inv = _vn_inv_on(log_rows, dev)
    perm = _sigma_on(log_rows, dev)
    if dev.type == "cpu":
        q = _composition_plain(vals, perm, aes_air.layout(key_size)[2], z4, a4,
                               w, vn_inv)
    else:
        q = stark_kernels.aes_composition(vals, perm, _groups_on(key_size, dev),
                                          (*z4, *a4), w, vn_inv)
    return q.cpu().numpy().view(np.uint32)


def _blinding(rand_bytes, cols: int) -> np.ndarray:
    """ZK_COEFFS random words per column, drawn as the reference draws them."""
    return np.frombuffer(rand_bytes(4 * cols * ZK_COEFFS),
                         dtype=np.uint32).reshape(cols, ZK_COEFFS)


def prove_aes_ctr(key: bytes, nonce: bytes, counter0: int, plaintext: bytes,
                  ciphertext: bytes, device=None, rand_bytes=None,
                  timings: dict | None = None) -> AesProof:
    """Prove the AES-CTR statement on `device` (default "cuda"). rand_bytes:
    callable n -> n bytes for the blinding (default secrets.token_bytes).
    timings: a dict to fill with the seconds of the stages trace, lde,
    merkle, interaction, composition, fri and openings (lde and merkle
    summed over both phases)."""
    from ..ops.ciphers import aes_ctr_encrypt

    dev = resolve_device(device)
    rand_bytes = secrets.token_bytes if rand_bytes is None else rand_bytes
    if len(key) not in (16, 32) or len(nonce) != 12:
        raise ValueError("key must be 16/32 bytes, nonce 12")
    if len(plaintext) != len(ciphertext) or len(plaintext) % 16:
        raise ValueError("plaintext/ciphertext must be equal multiples of 16B")
    n_blocks = len(plaintext) // 16
    if n_blocks == 0:
        raise ValueError("empty message")
    log_rows = max(MIN_LOG_ROWS, (n_blocks - 1).bit_length())
    if log_rows > MAX_LOG_ROWS:
        raise ValueError("message too large")
    rows = 1 << log_rows
    if counter0 + rows > 1 << 32:
        raise ValueError("counter overflow")
    t = time.perf_counter()

    # padding rows: pt := keystream  =>  public ct column is 0 there
    pad_ks = aes_ctr_encrypt(key, nonce, counter0 + n_blocks,
                             bytes(16 * (rows - n_blocks)))
    pt_rows = np.zeros((rows, 16), dtype=np.uint8)
    ct_rows = np.zeros((rows, 16), dtype=np.uint8)
    pt_rows[:n_blocks] = np.frombuffer(plaintext, dtype=np.uint8).reshape(-1, 16)
    ct_rows[:n_blocks] = np.frombuffer(ciphertext, dtype=np.uint8).reshape(-1, 16)
    if rows > n_blocks:
        pt_rows[n_blocks:] = np.frombuffer(pad_ks, dtype=np.uint8).reshape(-1, 16)

    stmt = AesStatement(
        key_size=len(key), log_rows=log_rows, n_blocks=n_blocks,
        nonce=bytes(nonce), counter0=counter0,
        pt_hash=hashlib.blake2s(plaintext, digest_size=32).digest(),
        ct_hash=hashlib.blake2s(ciphertext, digest_size=32).digest())

    ch = Channel(CHANNEL_SEED)
    stmt.mix_into(ch)

    n1, n2, groups = aes_air.layout(len(key))
    trace1, lk_u, lk_v = aes_air.generate_trace(key, nonce, counter0,
                                                pt_rows, ct_rows)
    mult = trace1[-1].copy()
    pub = aes_air.public_matrix(
        aes_air.public_bytes(nonce, counter0, ct_rows, rows))
    n, m, log_m = _domain_params(log_rows)
    fft_n, fft_m = _ffts(log_rows)
    t = _stage(timings, "trace", t, dev)

    # phase 1: blinded LDE of the committed columns, plain LDE of the public
    # ones, and the zero row: [phase 1 | public | zero, M]
    vals1 = _lde(fft_n, fft_m, np.concatenate([trace1, pub]), n1,
                 _blinding(rand_bytes, n1), dev)
    t = _stage(timings, "lde", t, dev)
    tree1 = merkle.commit_columns(vals1[:n1])
    ch.mix_bytes(tree1.root)
    t = _stage(timings, "merkle", t, dev)
    zq = ch.draw_qm31()
    aq = ch.draw_qm31()
    z4 = (zq[0][0], zq[0][1], zq[1][0], zq[1][1])
    a4 = (aq[0][0], aq[0][1], aq[1][0], aq[1][1])

    trace2 = _interaction(lk_u, lk_v, mult, z4, a4, rows, dev)
    t = _stage(timings, "interaction", t, dev)
    lde2 = _lde(fft_n, fft_m, trace2, n2, _blinding(rand_bytes, n2), dev)
    t = _stage(timings, "lde", t, dev)
    tree2 = merkle.commit_columns(lde2[:n2])
    ch.mix_bytes(tree2.root)
    t = _stage(timings, "merkle", t, dev)

    alpha = ch.draw_qm31()
    weights = _alpha_powers(alpha, n_constraints(len(key)))
    vals = torch.cat([vals1[:n1], lde2[:n2], vals1[n1:]])  # phase 1 | 2 | public | zero
    del vals1, lde2
    q_evals = _composition(vals, len(key), log_rows, z4, a4, weights)
    t = _stage(timings, "composition", t, dev)

    fri = FriContext(log_m, FRI_LOG_BLOWUP, dev)
    fri_proof, queries = fri.prove(
        np.ascontiguousarray(q_evals.T), ch, n_queries=N_QUERIES,
        pow_bits=POW_BITS, return_queries=True)
    t = _stage(timings, "fri", t, dev)

    qs = np.asarray(queries, dtype=np.int64)
    sqs = aes_air.sigma_perm(m, m // n)[qs].astype(np.int64)
    cols = torch.from_numpy(np.concatenate([qs, sqs])).to(dev)
    picked = vals[:n1 + n2, cols].cpu().numpy().view(np.uint32)
    nq = len(qs)
    o1, o1s, o2, o2s = [], [], [], []
    for j, (q, sq) in enumerate(zip(qs.tolist(), sqs.tolist())):
        o1.append(RowOpening(values=picked[:n1, j].copy(), path=tree1.open(q)))
        o1s.append(RowOpening(values=picked[:n1, nq + j].copy(),
                              path=tree1.open(sq)))
        o2.append(RowOpening(values=picked[n1:, j].copy(), path=tree2.open(q)))
        o2s.append(RowOpening(values=picked[n1:, nq + j].copy(),
                              path=tree2.open(sq)))
    _stage(timings, "openings", t, dev)
    return AesProof(stmt=stmt, root1=tree1.root, root2=tree2.root,
                    fri=fri_proof, openings1=o1, openings1s=o1s,
                    openings2=o2, openings2s=o2s)


def verify_aes_ctr(proof: AesProof, nonce: bytes, counter0: int,
                   plaintext: bytes, ciphertext: bytes, key_size: int,
                   device=None) -> bool:
    """Verify on the host; the public columns' FFT runs on `device`
    (default "cuda"). Any fault in the proof gives False."""
    dev = resolve_device(device)
    try:
        stmt = proof.stmt
        if stmt.key_size != key_size or key_size not in (16, 32):
            return False
        if not (MIN_LOG_ROWS <= stmt.log_rows <= MAX_LOG_ROWS):
            return False
        if len(plaintext) != len(ciphertext) or len(plaintext) % 16:
            return False
        n_blocks = len(plaintext) // 16
        rows = 1 << stmt.log_rows
        if (stmt.n_blocks != n_blocks or stmt.nonce != bytes(nonce)
                or stmt.counter0 != counter0 or n_blocks > rows
                or n_blocks == 0 or counter0 + rows > 1 << 32):
            return False
        if stmt.pt_hash != hashlib.blake2s(plaintext, digest_size=32).digest():
            return False
        if stmt.ct_hash != hashlib.blake2s(ciphertext, digest_size=32).digest():
            return False

        n, m, log_m = _domain_params(stmt.log_rows)
        if proof.fri.log_n != log_m or proof.fri.log_blowup != FRI_LOG_BLOWUP:
            return False
        if not (len(proof.openings1) == len(proof.openings1s)
                == len(proof.openings2) == len(proof.openings2s)
                == N_QUERIES):
            return False

        n1, n2, groups = aes_air.layout(key_size)
        ch = Channel(CHANNEL_SEED)
        stmt.mix_into(ch)
        ch.mix_bytes(proof.root1)
        zq = ch.draw_qm31()
        aq = ch.draw_qm31()
        z4 = (zq[0][0], zq[0][1], zq[1][0], zq[1][1])
        a4 = (aq[0][0], aq[0][1], aq[1][0], aq[1][1])
        ch.mix_bytes(proof.root2)
        alpha = ch.draw_qm31()
        weights = _alpha_powers(alpha, n_constraints(key_size))

        ct_rows = np.zeros((rows, 16), dtype=np.uint8)
        ct_rows[:n_blocks] = np.frombuffer(ciphertext,
                                           dtype=np.uint8).reshape(-1, 16)
        pub = aes_air.public_matrix(
            aes_air.public_bytes(nonce, counter0, ct_rows, rows))
        fft_n, fft_m = _ffts(stmt.log_rows)
        pub_lde = _lde(fft_n, fft_m, pub, 0, None, dev)[:-1]
        pub_lde = pub_lde.cpu().numpy().view(np.uint32)
        vn, _ = _vn_evals(stmt.log_rows)
        perm = aes_air.sigma_perm(m, m // n)

        opened = {}

        def layer0_expected(qidx: int):
            pos = len(opened)
            if pos >= N_QUERIES:
                return (P31, P31, P31, P31)
            opened[pos] = qidx
            sq = int(perm[qidx])
            rows_ok = []
            for ops, tree_root, width, idx in (
                    (proof.openings1, proof.root1, n1, qidx),
                    (proof.openings1s, proof.root1, n1, sq),
                    (proof.openings2, proof.root2, n2, qidx),
                    (proof.openings2s, proof.root2, n2, sq)):
                op = ops[pos]
                vrow = np.asarray(op.values, dtype=np.uint32)
                if vrow.shape != (width,):
                    return (P31, P31, P31, P31)
                if not merkle.verify_path(tree_root, idx,
                                          vrow.view(np.uint8).tobytes(),
                                          op.path):
                    return (P31, P31, P31, P31)
                rows_ok.append(vrow)
            r1, r1s, r2, r2s = rows_ok
            vals = np.concatenate(
                [r1, r2, pub_lde[:, qidx],
                 np.zeros(1, dtype=np.uint32)]).astype(np.uint64)
            vals_sh = np.concatenate(
                [r1s, r2s, pub_lde[:, sq],
                 np.zeros(1, dtype=np.uint32)]).astype(np.uint64)
            call = _host_constraints(vals, vals_sh, groups, z4, a4)
            comb = _host_weighted_sum(weights, call.astype(np.uint32))
            vninv = pow(int(vn[qidx]), -1, P31)
            return tuple(int(c) * vninv % P31 for c in comb)

        fri = FriContext(log_m, FRI_LOG_BLOWUP, dev)
        return fri.verify(proof.fri, ch, n_queries=N_QUERIES,
                          pow_bits=POW_BITS,
                          layer0_expected=layer0_expected)
    except Exception:
        return False


def _host_constraints(vals, vals_sh, groups, z4, a4):
    """numpy uint64 mirror of _composition's constraint vector (one point)."""
    P = P31
    out = []
    b = vals[groups["bool"]]
    out.append(b * ((1 + P - b) % P) % P)
    c = groups["const"]
    out.append((vals_sh[c] + P - vals[c]) % P)
    x = groups["xor"]
    xa, xb = vals[x["A"]], vals[x["B"]]
    out.append((vals[x["R"]] + 2 * (xa * xb % P) + 2 * P - xa - xb) % P)
    mx = groups["mix"]
    t = vals[mx["T"]]
    s = t.sum(axis=1) % P
    dec = (vals[mx["R"]] + 2 * vals[mx["K0"]] + 4 * vals[mx["K1"]]
           + 8 * vals[mx["K2"]]) % P
    out.append((s + P - dec) % P)

    def byte_val(refs8, v):
        acc = np.zeros(refs8.shape[0], dtype=np.uint64)
        for i in range(8):
            acc = (acc + (v[refs8[:, i]] << i)) % P
        return acc

    def qmul(a, b):
        a0, a1, a2, a3 = a
        b0, b1, b2, b3 = b
        c0 = (a0 * b0 + P * P - a1 * b1) % P
        c1 = (a0 * b1 + a1 * b0) % P
        d0 = (a2 * b2 + P * P - a3 * b3) % P
        d1 = (a2 * b3 + a3 * b2) % P
        e0 = (2 * d0 + P - d1) % P
        e1 = (d0 + 2 * d1) % P
        y0 = (a0 * b2 + a2 * b0 + 2 * P * P - a1 * b3 - a3 * b1) % P
        y1 = (a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0) % P
        return ((c0 + e0) % P, (c1 + e1) % P, y0, y1)

    def dens(u, v):
        av = tuple(a4[cc] * v % P for cc in range(4))
        return ((z4[0] + P - (u + av[0]) % P) % P,
                (z4[1] + P - av[1]) % P,
                (z4[2] + P - av[2]) % P,
                (z4[3] + P - av[3]) % P)

    lk = groups["lookup"]
    u = byte_val(lk["U"], vals)
    v = byte_val(lk["V"], vals)
    den = dens(u, v)
    f = tuple(vals[lk["F"][:, cc]] for cc in range(4))
    prod = qmul(f, den)
    lk_cs = np.stack([(prod[0] + P - 1) % P, prod[1], prod[2], prod[3]],
                     axis=1).reshape(-1)
    out.append(lk_cs)
    tb = groups["table"]
    tden = dens(vals[tb["TVAL"]], vals[tb["SVAL"]])
    g = tuple(np.asarray([vals[tb["G"][cc]]], dtype=np.uint64)
              for cc in range(4))
    tdenv = tuple(np.asarray([tden[cc]], dtype=np.uint64) for cc in range(4))
    gprod = qmul(g, tdenv)
    mt = vals[tb["M"]] * vals[tb["TACT"]] % P
    out.append(np.asarray([(gprod[0][0] + P - mt) % P, gprod[1][0],
                           gprod[2][0], gprod[3][0]], dtype=np.uint64))
    cum_cs = []
    for cc in range(4):
        fsum = vals_sh[lk["F"][:, cc]].sum() % P
        F_sh = (fsum + P - vals_sh[tb["G"][cc]]) % P
        cum_cs.append((vals_sh[groups["cum"][cc]] + 2 * P
                       - vals[groups["cum"][cc]] - F_sh) % P)
    out.append(np.asarray(cum_cs, dtype=np.uint64))
    e = groups["eq"]
    ks, pt = vals[e["KS"]], vals[e["PT"]]
    out.append((ks + pt + 3 * P - 2 * (ks * pt % P) - vals[e["CT"]]) % P)
    return np.concatenate(out)

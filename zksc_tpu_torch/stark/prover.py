"""Circle-STARK prover/verifier for the ChaCha20 stream AIR ("stark" engine).

Ported from the JAX package's ``stark/prover.py``, with the same
constants, transcript, DoS checks and wire form:

  prove:  statement mixed into the channel BEFORE any commitment ->
          trace gen on the host (reject invalid witness) -> blinded
          low-degree extension (zk: random coefficients in the
          V_N * <anything> slice) -> Merkle commit of the LDE's columns ->
          composition polynomial from the constraint index groups ->
          quotient by V_N -> FRI (host numpy, Merkle commits on the device).
  verify: statement fast-fail (hashes, sizes, DoS caps) -> channel replay ->
          public-column evaluation by the verifier itself -> FRI verify with
          per-query ALI consistency (host).

Where the device work runs: the circle FFTs (K7b), the trace commitment and
the larger Merkle layers (K7a), the composition (K7c) on the card; on the
CPU their plain versions (``circle.CircleFFT.*_plain``,
``_composition_plain``) and hashlib. The committed and the public columns go
through one batched interpolate and one evaluate (the reference transforms
them in two vmaps; the values are the same). ``prove_stream`` takes its
blinding bytes from ``rand_bytes`` (default ``secrets.token_bytes``), drawn
exactly as the reference draws them, so a test can give both packages the
same bytes and compare the envelopes byte for byte.

Domain layout: trace on the size-N standard coset; commitments and FRI on a
size-M = 4 * next_pow2(N + 2q + 1) coset, q = ZK_COEFFS blinding
coefficients per column.
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
from . import chacha_air, merkle
from .channel import Channel
from .circle import CircleFFT
from .fri import FriContext, FriProof, _qm_mul_scalar_np
from .m31 import P31, m31_add, m31_mul, m31_sub

N_QUERIES = 42
POW_BITS = 16
ZK_COEFFS = 50          # > N_QUERIES: openings are q-wise independent
FRI_LOG_BLOWUP = 2      # accepted support = M / 4
# 64-row floor: blinding coefficient slots live at indices [N, N+q) and only
# vanish on the trace domain while they carry the v_logN basis factor, i.e.
# while q < N.
MIN_LOG_ROWS = 6
# DoS / memory bound, as the reference's (stark/prover.py:55-63).
MAX_LOG_ROWS = 20
CHANNEL_SEED = b"zksc-tpu-stark-chacha-v1"
PLAIN_CONSTRAINTS = 2048   # constraints per step of _composition_plain


@dataclass
class StreamStatement:
    log_rows: int
    n_blocks: int            # real (unpadded) blocks
    nonce: bytes
    counter0: int
    pt_hash: bytes
    ct_hash: bytes

    def mix_into(self, ch: Channel):
        ch.mix_u64(self.log_rows)
        ch.mix_u64(self.n_blocks)
        ch.mix_bytes(self.nonce)
        ch.mix_u64(self.counter0)
        ch.mix_bytes(self.pt_hash)
        ch.mix_bytes(self.ct_hash)


@dataclass
class TraceOpening:
    values: np.ndarray       # uint32[n_committed] LDE row at the query index
    path: list


@dataclass
class StreamProof:
    stmt: StreamStatement
    trace_root: bytes
    fri: FriProof
    openings: list           # [per query] TraceOpening

    def to_json_dict(self) -> dict:
        """JSON-serializable proof (base64 payloads)."""
        import base64
        b64 = lambda b: base64.b64encode(b).decode()
        return {
            "protocol": "circle-stark",
            "statement": {
                "logRows": self.stmt.log_rows,
                "nBlocks": self.stmt.n_blocks,
                "nonce": b64(self.stmt.nonce),
                "counter": self.stmt.counter0,
                "ptHash": b64(self.stmt.pt_hash),
                "ctHash": b64(self.stmt.ct_hash),
            },
            "traceRoot": b64(self.trace_root),
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
            "traceOpenings": [{
                "values": b64(np.ascontiguousarray(o.values).tobytes()),
                "path": [b64(x) for x in o.path],
            } for o in self.openings],
        }

    def to_envelope(self) -> dict:
        """Compact wire form: base64(bincode) payload (interop/bincode.py)."""
        from ..interop.bincode import stream_proof_envelope
        return stream_proof_envelope(self)

    @classmethod
    def from_json_dict(cls, d: dict) -> "StreamProof":
        import base64
        from .fri import FriLayerOpening
        if "proof" in d:       # base64-bincode envelope
            from ..interop.bincode import decode_stream_proof
            return decode_stream_proof(base64.b64decode(d["proof"]))
        ub = base64.b64decode
        s = d["statement"]
        stmt = StreamStatement(
            log_rows=int(s["logRows"]), n_blocks=int(s["nBlocks"]),
            nonce=ub(s["nonce"]), counter0=int(s["counter"]),
            pt_hash=ub(s["ptHash"]), ct_hash=ub(s["ctHash"]))
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
        openings = [TraceOpening(
            values=np.frombuffer(ub(o["values"]), dtype=np.uint32),
            path=[ub(x) for x in o["path"]],
        ) for o in d["traceOpenings"]]
        return cls(stmt=stmt, trace_root=ub(d["traceRoot"]), fri=fri,
                   openings=openings)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _domain_params(log_rows: int):
    n = 1 << log_rows
    d = _next_pow2(n + 2 * ZK_COEFFS + 1)
    log_m = d.bit_length() - 1 + FRI_LOG_BLOWUP
    return n, 1 << log_m, log_m


@functools.lru_cache(maxsize=8)
def _ffts(log_rows: int):
    _, _, log_m = _domain_params(log_rows)
    return CircleFFT(log_rows), CircleFFT(log_m)


@functools.lru_cache(maxsize=8)
def _vn_evals(log_rows: int) -> tuple:
    """V_N(x) = pi^{(log_rows - 1)}(x) on the M-domain, and its inverses."""
    _, m, _ = _domain_params(log_rows)
    fft_m = _ffts(log_rows)[1]
    x = fft_m.domain_x.astype(np.uint64)
    for _ in range(log_rows - 1):
        x = (2 * x * x - 1) % P31
    inv = np.array([pow(int(v), -1, P31) for v in x[: m // 2]], dtype=np.uint64)
    # conjugate halves share x, so inverses repeat
    return x.astype(np.uint32), np.concatenate([inv, inv]).astype(np.uint32)


@functools.lru_cache(maxsize=16)
def _vn_inv_on(log_rows: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_vn_evals(log_rows)[1].astype(np.int32)).to(device)


@functools.lru_cache(maxsize=4)
def _groups_on(device: torch.device) -> tuple:
    """K7c's packed index groups of the AIR (chacha_air.layout()) on
    `device`, kept for the process's lifetime: (idx, off, n)."""
    n_comm, groups = chacha_air.layout()
    idx, off, n = stark_kernels.pack_groups(groups)
    if idx.min() < 0 or idx.max() > n_comm + chacha_air.N_PUBLIC:
        raise ValueError("an index group reaches outside the value rows")
    return torch.from_numpy(idx).to(device), off, n


def _alpha_powers(alpha, n: int) -> np.ndarray:
    """[n, 4] uint32 powers alpha^0..alpha^{n-1} (chunked numpy ladder)."""
    af = (alpha[0][0], alpha[0][1], alpha[1][0], alpha[1][1])
    chunk = min(n, 1024)
    base = np.zeros((chunk, 4), dtype=np.uint64)
    base[0] = (1, 0, 0, 0)
    for i in range(1, chunk):
        base[i] = _qm_mul_scalar_np(af, base[i - 1: i])[0]
    out = [base]
    stepv = _qm_mul_scalar_np(af, base[-1:])[0]    # alpha^chunk
    cur = base
    total = chunk
    while total < n:
        step = (int(stepv[0]), int(stepv[1]), int(stepv[2]), int(stepv[3]))
        cur = _qm_mul_scalar_np(step, cur)
        out.append(cur)
        total += chunk
    return np.concatenate(out)[:n].astype(np.uint32)


def _constraint_values(name: str, g):
    """The constraints of group `name` (prover.py:242-264), from the gather
    `g(field)` of its rows: int64 [n, M] canonical values."""
    two = 2
    if name == "bool":
        b = g(None)
        return m31_mul(b, m31_sub(1, b))
    if name == "add":
        lhs = m31_add(g("R"), m31_mul(two, g("C")))
        rhs = m31_add(g("A"), m31_add(g("B"), g("Cin")))
        return m31_sub(lhs, rhs)
    if name == "addx":
        u, w = g("U"), g("W")
        uw = m31_mul(u, w)
        avirt = m31_sub(m31_add(u, w), m31_mul(two, uw))
        lhs = m31_add(g("R"), m31_mul(two, g("C")))
        rhs = m31_add(avirt, m31_add(g("B"), g("Cin")))
        return m31_sub(lhs, rhs)
    if name == "xor":
        xa, xb = g("A"), g("B")
        return m31_sub(m31_add(g("R"), m31_mul(two, m31_mul(xa, xb))),
                       m31_add(xa, xb))
    ks, pt = g("KS"), g("PT")
    return m31_sub(m31_add(ks, pt), m31_add(m31_mul(two, m31_mul(ks, pt)), g("CT")))


def _composition_plain(vals: torch.Tensor, groups: dict, weights: torch.Tensor,
                       vn_inv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K7c (prover.py:235-274): vals int32 [R, M] (committed
    LDE | public LDE | zero row), groups as chacha_air.layout() gives them,
    weights [K, 4], vn_inv [M]. Returns Q = C(x) / V_N(x) as int32 [4, M].
    Constraint order (alpha powers): bool, add, addx, xor, eq; the sums run
    over slices of PLAIN_CONSTRAINTS constraints (exact mod p, so the
    reference's values)."""
    dev = vals.device
    M = vals.shape[1]
    w_all = weights.to(device=dev, dtype=torch.int64)
    acc = torch.zeros((4, M), dtype=torch.int64, device=dev)
    k = 0
    for name, fields in stark_kernels.GROUP_FIELDS:
        grp = groups[name]
        n = len(grp if fields == (None,) else grp[fields[0]])
        for lo in range(0, n, PLAIN_CONSTRAINTS):
            hi = min(n, lo + PLAIN_CONSTRAINTS)

            def g(field):
                rows = grp if field is None else grp[field]
                idx = torch.as_tensor(np.asarray(rows[lo:hi], dtype=np.int64),
                                      device=dev)
                return vals[idx].to(torch.int64)
            c = _constraint_values(name, g)                # [hi - lo, M]
            w = w_all[k + lo:k + hi]
            for q in range(4):
                acc[q] = m31_add(acc[q], m31_mul(w[:, q:q + 1], c).sum(0) % P31)
        k += n
    return m31_mul(acc, vn_inv.to(device=dev, dtype=torch.int64)).to(torch.int32)


def _composition(vals: torch.Tensor, weights: np.ndarray, log_rows: int) -> np.ndarray:
    """Q = C(x) / V_N(x) as uint32 [4, M]: K7c on the card, the plain
    version on the CPU."""
    dev = vals.device
    w = torch.from_numpy(weights.astype(np.int32)).to(dev)
    vn_inv = _vn_inv_on(log_rows, dev)
    if dev.type == "cpu":
        q = _composition_plain(vals, chacha_air.layout()[1], w, vn_inv)
    else:
        idx, off, n = _groups_on(dev)
        q = stark_kernels.composition(vals, idx, off, n, w, vn_inv)
    return q.cpu().numpy().view(np.uint32)


def _n_constraints(groups) -> int:
    return (len(groups["bool"]) + len(groups["add"]["R"])
            + len(groups["addx"]["R"]) + len(groups["xor"]["R"])
            + len(groups["eq"]["KS"]))


def _split_blocks(data: bytes, rows: int, pad_words: np.ndarray) -> np.ndarray:
    """bytes -> uint32[rows, 16] LE words; rows beyond the data take
    pad_words values."""
    n_real = len(data) // 64
    out = pad_words.copy()
    if n_real:
        words = np.frombuffer(data, dtype="<u4").reshape(n_real, 16)
        out[:n_real] = words
    return out


def _lde(fft_n: CircleFFT, fft_m: CircleFFT, cols: np.ndarray, n_blinded: int,
         blind: np.ndarray, device) -> torch.Tensor:
    """The values [rows of cols + 1, M] on `device`: the low-degree
    extension of each column of `cols` [*, N] (its first n_blinded columns
    with the blinding coefficients at [N, N + ZK_COEFFS)), and a zero row.
    The evaluation reads only the coefficients that can be non-zero: a
    block [rows + 1, K], K = N + ZK_COEFFS rounded up to a multiple of 4
    (N without blinding); the rest are zero."""
    n, m = fft_n.n, fft_m.n
    coeffs = fft_n.interpolate(torch.from_numpy(cols.astype(np.int32)).to(device))
    k = min(m, -(-(n + ZK_COEFFS) // 4) * 4) if n_blinded else n
    cm = torch.zeros((cols.shape[0] + 1, k), dtype=torch.int32, device=device)
    cm[:cols.shape[0], :n] = coeffs
    if n_blinded:
        cm[:n_blinded, n:n + ZK_COEFFS] = torch.from_numpy(
            (blind % P31).astype(np.int32)).to(device)
    return fft_m.evaluate(cm)


def _stage(timings, name: str, t0: float, device) -> float:
    """Add the seconds since t0 to `name` (after the device is done)."""
    if timings is None:
        return t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    timings[name] = timings.get(name, 0.0) + t - t0
    return t


def prove_stream(key: bytes, nonce: bytes, counter0: int, plaintext: bytes,
                 ciphertext: bytes, device=None, rand_bytes=None,
                 timings: dict | None = None) -> StreamProof:
    """Prove the ChaCha20 stream statement on `device` (default "cuda").
    rand_bytes: callable n -> n bytes for the blinding (default
    secrets.token_bytes). timings: a dict to fill with the seconds of the
    stages trace, lde, merkle, composition, fri and openings."""
    from ..ops.ciphers import chacha20_encrypt

    dev = resolve_device(device)
    rand_bytes = secrets.token_bytes if rand_bytes is None else rand_bytes
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError("key must be 32 bytes, nonce 12")
    if len(plaintext) != len(ciphertext) or len(plaintext) % 64:
        raise ValueError("plaintext/ciphertext must be equal multiples of 64B")
    n_blocks = len(plaintext) // 64
    if n_blocks == 0:
        raise ValueError("empty message")
    log_rows = max(MIN_LOG_ROWS, (n_blocks - 1).bit_length())
    if log_rows > MAX_LOG_ROWS:
        raise ValueError("message too large")
    rows = 1 << log_rows
    if counter0 + rows > 1 << 32:
        raise ValueError("counter overflow")
    t = time.perf_counter()

    # padding rows: plaintext := keystream, ciphertext := 0
    pad_ks = chacha20_encrypt(key, nonce, counter0 + n_blocks,
                              bytes(64 * (rows - n_blocks)))
    pad_pt = np.zeros((rows, 16), dtype=np.uint32)
    if rows > n_blocks:
        pad_pt[n_blocks:] = np.frombuffer(pad_ks, dtype="<u4").reshape(-1, 16)
    pt_rows = _split_blocks(plaintext, rows, pad_pt)
    ct_rows = _split_blocks(ciphertext, rows,
                            np.zeros((rows, 16), dtype=np.uint32))

    stmt = StreamStatement(
        log_rows=log_rows, n_blocks=n_blocks, nonce=bytes(nonce),
        counter0=counter0,
        pt_hash=hashlib.blake2s(plaintext, digest_size=32).digest(),
        ct_hash=hashlib.blake2s(ciphertext, digest_size=32).digest())

    ch = Channel(CHANNEL_SEED)
    stmt.mix_into(ch)

    n_comm, groups = chacha_air.layout()
    trace = chacha_air.generate_trace(key, nonce, counter0, pt_rows, ct_rows)
    pub_bits = chacha_air.public_bit_matrix(
        chacha_air.public_words(nonce, counter0, ct_rows, rows))
    n, m, log_m = _domain_params(log_rows)
    fft_n, fft_m = _ffts(log_rows)
    t = _stage(timings, "trace", t, dev)

    # blinded LDE of the committed columns, plain LDE of the public ones,
    # and the zero row: vals [committed | public | zero, M]
    blind = np.frombuffer(rand_bytes(4 * n_comm * ZK_COEFFS),
                          dtype=np.uint32).reshape(n_comm, ZK_COEFFS)
    vals = _lde(fft_n, fft_m, np.concatenate([trace, pub_bits]), n_comm,
                blind, dev)
    lde = vals[:n_comm]
    t = _stage(timings, "lde", t, dev)

    tree = merkle.commit_columns(lde)
    ch.mix_bytes(tree.root)
    t = _stage(timings, "merkle", t, dev)

    alpha = ch.draw_qm31()
    weights = _alpha_powers(alpha, _n_constraints(groups))
    q_evals = _composition(vals, weights, log_rows)            # [4, M]
    t = _stage(timings, "composition", t, dev)

    fri = FriContext(log_m, FRI_LOG_BLOWUP, dev)
    fri_proof, queries = fri.prove(
        np.ascontiguousarray(q_evals.T), ch, n_queries=N_QUERIES,
        pow_bits=POW_BITS, return_queries=True)
    t = _stage(timings, "fri", t, dev)

    picked = lde[:, torch.as_tensor(queries, device=dev)].cpu().numpy()
    picked = picked.view(np.uint32)
    openings = [TraceOpening(values=picked[:, j].copy(), path=tree.open(q))
                for j, q in enumerate(queries)]
    _stage(timings, "openings", t, dev)
    return StreamProof(stmt=stmt, trace_root=tree.root, fri=fri_proof,
                       openings=openings)


def _host_weighted_sum(weights: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """QM31 sum_i w_i * v_i: weights uint32[n,4], vals uint32[n] m31."""
    v = vals.astype(np.uint64)
    return np.stack([(weights[:, c].astype(np.uint64) * v % P31).sum() % P31
                     for c in range(4)])


def verify_stream(proof: StreamProof, nonce: bytes, counter0: int,
                  plaintext: bytes, ciphertext: bytes, device=None) -> bool:
    """Verify on the host; the public columns' FFT runs on `device`
    (default "cuda"). Any fault in the proof gives False."""
    dev = resolve_device(device)
    try:
        stmt = proof.stmt
        if not (MIN_LOG_ROWS <= stmt.log_rows <= MAX_LOG_ROWS):
            return False
        if len(plaintext) != len(ciphertext) or len(plaintext) % 64:
            return False
        n_blocks = len(plaintext) // 64
        rows = 1 << stmt.log_rows
        if (stmt.n_blocks != n_blocks or stmt.nonce != bytes(nonce)
                or stmt.counter0 != counter0 or n_blocks > rows
                or counter0 + rows > 1 << 32):
            return False
        if stmt.pt_hash != hashlib.blake2s(plaintext, digest_size=32).digest():
            return False
        if stmt.ct_hash != hashlib.blake2s(ciphertext, digest_size=32).digest():
            return False

        n, m, log_m = _domain_params(stmt.log_rows)
        if proof.fri.log_n != log_m or proof.fri.log_blowup != FRI_LOG_BLOWUP:
            return False
        if len(proof.openings) != N_QUERIES:
            return False

        ch = Channel(CHANNEL_SEED)
        stmt.mix_into(ch)
        ch.mix_bytes(proof.trace_root)
        alpha = ch.draw_qm31()
        n_comm, groups = chacha_air.layout()
        weights = _alpha_powers(alpha, _n_constraints(groups))

        # verifier-computed public columns on the M-domain
        fft_n, fft_m = _ffts(stmt.log_rows)
        ct_rows = _split_blocks(ciphertext, rows,
                                np.zeros((rows, 16), dtype=np.uint32))
        pub_bits = chacha_air.public_bit_matrix(
            chacha_air.public_words(nonce, counter0, ct_rows, rows))
        pub_lde = _lde(fft_n, fft_m, pub_bits, 0, None, dev)[:-1]
        pub_lde = pub_lde.cpu().numpy().view(np.uint32)
        vn, _ = _vn_evals(stmt.log_rows)

        openings_by_pos = {}

        def layer0_expected(qidx: int):
            pos = len(openings_by_pos)
            if pos >= len(proof.openings):
                return (P31, P31, P31, P31)        # impossible value -> fail
            op = proof.openings[pos]
            openings_by_pos[pos] = qidx
            vals_row = np.asarray(op.values, dtype=np.uint32)
            if vals_row.shape != (n_comm,):
                return (P31, P31, P31, P31)
            leaf = vals_row.view(np.uint8).tobytes()
            if not merkle.verify_path(proof.trace_root, qidx, leaf, op.path):
                return (P31, P31, P31, P31)
            full = np.concatenate([vals_row, pub_lde[:, qidx],
                                   np.zeros(1, dtype=np.uint32)])

            def g(idx):
                return full[idx].astype(np.uint64)

            cs = []
            b = g(groups["bool"])
            cs.append(b * ((1 + P31 - b) % P31) % P31)
            a = groups["add"]
            cs.append((g(a["R"]) + 2 * g(a["C"]) + 3 * P31 - g(a["A"])
                       - g(a["B"]) - g(a["Cin"])) % P31)
            ax = groups["addx"]
            u, w = g(ax["U"]), g(ax["W"])
            avirt = (u + w + 2 * P31 - 2 * (u * w % P31)) % P31
            cs.append((g(ax["R"]) + 2 * g(ax["C"]) + 3 * P31 - avirt
                       - g(ax["B"]) - g(ax["Cin"])) % P31)
            x = groups["xor"]
            xa, xb = g(x["A"]), g(x["B"])
            cs.append((g(x["R"]) + 2 * (xa * xb % P31) + 2 * P31 - xa - xb)
                      % P31)
            e = groups["eq"]
            ks, pt = g(e["KS"]), g(e["PT"])
            cs.append((ks + pt + 3 * P31 - 2 * (ks * pt % P31)
                       - g(e["CT"])) % P31)
            call = np.concatenate(cs)
            comb = _host_weighted_sum(weights, call.astype(np.uint32))
            vninv = pow(int(vn[qidx]), -1, P31)
            return tuple(int(c) * vninv % P31 for c in comb)

        fri = FriContext(log_m, FRI_LOG_BLOWUP, dev)
        return fri.verify(proof.fri, ch, n_queries=N_QUERIES,
                          pow_bits=POW_BITS, layer0_expected=layer0_expected)
    except Exception:
        return False

"""stwo-compatible ChaCha20 stream prover ("stark-stwo"): proofs
byte-identical to the reference stwo prover's, which the stwo verifier
accepts.

Ported from the JAX package's ``stark/stwo_compat/prover.py``, with the same
transcript, Merkle layout, quotient combination, FRI folds and bincode
schema. It draws no randomness: the bytes are a function of the inputs.
Every stage that scales with the trace runs on tensors on `device` (default
"cuda"), on the card through the stark engine's kernels:

  trace         trace.stream_trace: int64 word ops over the block axis,
                one walk of the block function (the padding rows' ciphertext
                is their keystream from the same walk)
  lde           cfft: K7b (interpolate [33280, n], evaluate [33281, 2n])
  merkle        the trace tree by K7a from the LDE in place; the
                composition tree (8 columns) by K7a from
                stark.merkle.DEVICE_MIN_LEAVES leaves
  composition   K7c over air.layout()'s groups, weights alpha^(54783 -
                emission index), then f = g + lambda V (two dot products)
  samples       QM31 weighted sums of the coefficient rows at the OODS
                point's basis (built on the device, a doubling a bit)
  quotient      the gamma-weighted sum over 33,288 columns, then the
                numerator, the QM31 inverse of the denominator and the
                product, one pass over the 2n positions
  fri           FRI's folds over <= 2n QM31 values and the grind: host
                Python, as the reference (the layer trees by K7a from
                DEVICE_MIN_LEAVES leaves)
  openings      the queried LDE rows, copied to the host once; assembly
  encode        bincode (``prove_stream_bytes``)

On a CPU tensor the kernels' plain versions run instead (CircleFFT's
``*_plain``, hashlib, ``stark.prover._composition_plain``), with the same
bytes.
"""
from __future__ import annotations

import functools
import hashlib
import struct
import time

import numpy as np
import torch

from ...device import resolve_device
from ...ops import stark_kernels
from .. import merkle as stark_merkle
from ..m31 import (P31, m31_inv, m31_mul, m31_neg, m31_reduce, m31_sub,
                   qm31_add, qm31_inv, qm31_mul, qm31_sub)
from ..prover import _composition_plain
from . import cfft, field as F
from .air import N_COLS, N_CONSTRAINTS, layout
from .channel import Blake2sChannel
from .circle import CanonicCoset
from .codec import FriLayer, StwoStreamProof, encode_stream_proof
from .fri import LineDomainIter, fold_circle_pair, fold_line_pair
from .merkle import EMPTY_ROOT, commit_tensor, decommit as merkle_decommit
from .quotients import oods_point
from .trace import stream_trace
from .verifier import MAX_LOG_SIZE, draw_query_positions

# stwo's PcsConfig for this statement (the verifier's floors)
LOG_BLOWUP = 1
POW_BITS = 10
N_QUERIES = 3
MIN_LOG_SIZE = 4
SUM_CHUNK = 1 << 23          # int64 products a step of _qm31_dot


def _stage(timings, name: str, t0: float, device) -> float:
    """Add the seconds since t0 to `name` (after the device is done)."""
    if timings is None:
        return t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    timings[name] = timings.get(name, 0.0) + t - t0
    return t


# ---------------------------------------------------------------- QM31 vectors

def _q(t: torch.Tensor):
    """int64 [..., 4] -> the m31 module's ((a0, a1), (b0, b1))."""
    return ((t[..., 0], t[..., 1]), (t[..., 2], t[..., 3]))


def _t(q) -> torch.Tensor:
    return torch.stack([q[0][0], q[0][1], q[1][0], q[1][1]], dim=-1)


def _const(v, device) -> tuple:
    """A host QM31 tuple as 0-dim int64 tensors in the m31 module's form."""
    c = torch.tensor(v, dtype=torch.int64, device=device)
    return _q(c)


def qm31_powers(x, n: int, device) -> torch.Tensor:
    """int64 [n, 4]: x^0 .. x^(n-1) for a host QM31 x, by doubling (each
    step multiplies the powers so far by x^len)."""
    out = torch.tensor([[1, 0, 0, 0]], dtype=torch.int64, device=device)
    step = x
    while out.shape[0] < n:
        out = torch.cat([out, _t(qm31_mul(_q(out), _const(step, device)))])
        step = F.mul(step, step)
    return out[:n]


def _qm31_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_j a[:, j] * b[j] for M31 a [X, J] and QM31 b [J, 4]: int64 [X, 4]
    canonical. Each product is reduced before the sum (a sum of unreduced
    products would overflow int64), a slice of J at a time."""
    X, J = a.shape
    acc = torch.zeros((X, 4), dtype=torch.int64, device=a.device)
    step = max(1, SUM_CHUNK // max(1, 4 * X))
    for j0 in range(0, J, step):
        j1 = min(J, j0 + step)
        prod = a[:, j0:j1, None].to(torch.int64) * b[None, j0:j1, :]
        acc = (acc + m31_reduce(prod).sum(1)) % P31
    return acc


def _to_host(t: torch.Tensor) -> list:
    """int [..., 4] -> list of QM31 tuples."""
    return [tuple(r) for r in t.cpu().tolist()]


# ---------------------------------------------------------------- domains

@functools.lru_cache(maxsize=32)
def _commit_domain_on(log_size: int, device: torch.device) -> tuple:
    """(xs, ys, V, V^-1) int64 on `device` at the commitment domain's
    stored positions (log size log_size + 1): CircleFFT's domain points
    gathered to stored order by cfft's row map; V = pi^(log_size - 1)(x),
    the trace domain's vanishing polynomial."""
    log_domain = log_size + LOG_BLOWUP
    f = cfft.fft(log_domain)
    to_stored = cfft._maps_on(log_domain, device)[1]
    xs, ys = (torch.from_numpy(a.astype(np.int64)).to(device)[to_stored]
              for a in (f.domain_x, f.domain_y))
    v = xs
    for _ in range(log_size - 1):
        v = (2 * m31_mul(v, v) - 1) % P31
    return xs, ys, v, m31_inv(v)


def _basis(point, log_size: int, device) -> torch.Tensor:
    """int64 [2^log_size, 4]: trace.basis_eval_qm31(point, log_size) on
    `device`, as a tensor product: [1, y], then each pi^k(x) multiplies a
    copy of the rows so far (bit 1 + k of the index)."""
    x, y = point
    out = torch.tensor([F.ONE, y], dtype=torch.int64, device=device)
    for _ in range(log_size - 1):
        out = torch.cat([out, _t(qm31_mul(_q(out), _const(x, device)))])
        x = F.sub(F.add(F.mul(x, x), F.mul(x, x)), F.ONE)
    return out


@functools.lru_cache(maxsize=4)
def _layout_on(device: torch.device) -> tuple:
    """K7c's packed groups (idx on `device`, off, n) and the emission
    order (on `device`), kept for the process's lifetime."""
    groups, order = layout()
    idx, off, n = stark_kernels.pack_groups(groups)
    if idx.min() < 0 or idx.max() > N_COLS:
        raise ValueError("an index group reaches outside the value rows")
    return torch.from_numpy(idx).to(device), off, n, torch.from_numpy(order).to(device)


def composition(vals: torch.Tensor, alpha, log_size: int) -> torch.Tensor:
    """stwo's composition accumulator over V: int32 [4, 2n] at the stored
    commitment positions, from vals [N_COLS + 1, 2n] (the LDE and a zero
    row). K7c on the card, its plain version on the CPU; constraint k of
    K7c's order weighted alpha^(N_CONSTRAINTS - 1 - emission index of k)."""
    dev = vals.device
    idx, off, n, order = _layout_on(dev)
    weights = qm31_powers(alpha, N_CONSTRAINTS, dev)[N_CONSTRAINTS - 1 - order]
    weights = weights.to(torch.int32)
    vn_inv = _commit_domain_on(log_size, dev)[3].to(torch.int32)
    if dev.type == "cpu":
        return _composition_plain(vals, layout()[0], weights, vn_inv)
    return stark_kernels.composition(vals, idx, off, n, weights, vn_inv)


# ---------------------------------------------------------------- prover

def _words(data: bytes, rows: int, device) -> torch.Tensor:
    """bytes (whole blocks) -> int64 [rows, 16] LE words, zero rows after."""
    out = np.zeros((rows, 16), dtype=np.int64)
    if data:
        out[:len(data) // 64] = np.frombuffer(data, dtype="<u4").reshape(-1, 16)
    return torch.from_numpy(out).to(device)


def prove_stream(key: bytes, nonce: bytes, counter: int, plaintext: bytes,
                 ciphertext: bytes, device=None,
                 timings: dict | None = None) -> StwoStreamProof:
    """The stwo proof of the ChaCha20 stream statement, on `device`
    (default "cuda"). timings: a dict to fill with the seconds of the
    stages trace, lde, merkle, composition, samples, quotient, fri and
    openings. Raises ValueError on a bad statement, a ciphertext that is
    not the encryption, or a counter that would pass 2^32 - 1."""
    dev = resolve_device(device)
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError("key must be 32 bytes, nonce 12")
    if not plaintext or len(plaintext) % 64:
        raise ValueError("plaintext must be a non-empty multiple of 64")
    if len(ciphertext) != len(plaintext):
        raise ValueError("ciphertext length mismatch")
    n_blocks = len(plaintext) // 64
    if counter < 0 or counter + n_blocks - 1 > 0xFFFFFFFF:
        raise ValueError("counter overflow: counter + n_blocks - 1 exceeds "
                         "2^32 - 1")
    log_size = max((n_blocks - 1).bit_length() if n_blocks > 1 else 0,
                   MIN_LOG_SIZE)
    if log_size > MAX_LOG_SIZE:
        raise ValueError("message too large")
    n = 1 << log_size
    n2 = n << LOG_BLOWUP
    t = time.perf_counter()

    key_w = [int.from_bytes(key[i * 4:i * 4 + 4], "little") for i in range(8)]
    nonce_w = [int.from_bytes(nonce[i * 4:i * 4 + 4], "little")
               for i in range(3)]
    counters = (counter + torch.arange(n, device=dev)) & 0xFFFFFFFF
    trace, valid = stream_trace(key_w, nonce_w, counters,
                                _words(plaintext, n, dev),
                                _words(ciphertext, n, dev), n_blocks)
    if not valid:
        raise ValueError("ciphertext does not match encryption")
    t = _stage(timings, "trace", t, dev)

    trace_coeffs = cfft.interpolate(trace)                  # [N_COLS, n]
    del trace
    padded = torch.zeros((N_COLS + 1, n), dtype=torch.int32, device=dev)
    padded[:N_COLS] = trace_coeffs
    vals = cfft.evaluate(padded, log_size + LOG_BLOWUP)     # [N_COLS + 1, n2]
    del padded
    lde = vals[:N_COLS]
    t = _stage(timings, "lde", t, dev)

    pt_hash = hashlib.blake2s(plaintext).digest()
    ct_hash = hashlib.blake2s(ciphertext).digest()

    # --- channel: preprocessed commit + statement ---
    ch = Blake2sChannel()
    ch.mix_root(EMPTY_ROOT)
    ch.mix_u64(log_size)
    for i in range(3):
        ch.mix_u64(nonce_w[i])
    ch.mix_u64(counter)
    for i in range(8):
        ch.mix_u64(struct.unpack_from("<I", pt_hash, 4 * i)[0])
    for i in range(8):
        ch.mix_u64(struct.unpack_from("<I", ct_hash, 4 * i)[0])

    # --- trace tree ---
    tree1 = stark_merkle.commit_columns(lde)
    ch.mix_root(tree1.root)
    random_coeff = ch.draw_felt()
    t = _stage(timings, "merkle", t, dev)

    # --- composition, then f = g + lambda V: lambda = <f, V> / <V, V> ---
    comp = composition(vals, random_coeff, log_size).to(torch.int64)  # [4, n2]
    V = _commit_domain_on(log_size, dev)[2]
    vv_inv = m31_inv(m31_mul(V, V).sum() % P31)
    lams = m31_mul(m31_mul(comp, V).sum(1) % P31, vv_inv)            # [4]
    gcols = m31_sub(comp, m31_mul(lams[:, None], V))
    tree2_cols = torch.cat([gcols, lams[:, None].expand(4, n2)]).to(torch.int32)
    t = _stage(timings, "composition", t, dev)

    # --- composition tree ---
    tree2 = commit_tensor(tree2_cols)
    ch.mix_root(tree2.root)
    oods_t = ch.draw_felt()
    P_pt = oods_point(oods_t)
    t = _stage(timings, "merkle", t, dev)

    # --- sampled values ---
    coeffs_g = cfft.interpolate(tree2_cols[:4])
    lam_q = torch.zeros((4, 4), dtype=torch.int64, device=dev)
    lam_q[:, 0] = lams
    sampled = torch.cat([_qm31_dot(trace_coeffs, _basis(P_pt, log_size, dev)),
                         _qm31_dot(coeffs_g, _basis(P_pt, log_size + LOG_BLOWUP,
                                                    dev)),
                         lam_q])   # [N_COLS + 8, 4]
    sampled_flat = _to_host(sampled)
    t = _stage(timings, "samples", t, dev)
    ch.mix_felts(sampled_flat)
    gamma = ch.draw_felt()

    # --- quotient column on the commitment domain ---
    quot = _quotients(P_pt, gamma, sampled, lde, tree2_cols, log_size)
    t = _stage(timings, "quotient", t, dev)

    # --- FRI commit phase ---
    dom = CanonicCoset(log_size + LOG_BLOWUP).circle_domain()
    fri_layers = []                  # (values, tree)
    treeF = _commit_qm31(quot, dev)
    ch.mix_root(treeF.root)
    alpha = ch.draw_felt()
    fri_layers.append((quot, treeF))
    vals_f = [fold_circle_pair(quot[2 * k], quot[2 * k + 1],
                               dom.at_stored(2 * k)[1], alpha)
              for k in range(n2 // 2)]
    half = dom.half_coset
    ld = LineDomainIter(half.initial_index, half.step_index, half.log_size)
    inner = []
    while len(vals_f) > 2:
        treeI = _commit_qm31(vals_f, dev)
        ch.mix_root(treeI.root)
        alpha = ch.draw_felt()
        inner.append((vals_f, treeI))
        vals_f = [fold_line_pair(vals_f[2 * k], vals_f[2 * k + 1],
                                 ld.x_at_stored(2 * k), alpha)
                  for k in range(len(vals_f) // 2)]
        ld = ld.double()
    assert len(vals_f) == 2 and vals_f[0] == vals_f[1], "fri fold inconsistency"
    last_coeff = vals_f[0]
    ch.mix_felts([last_coeff])

    # --- pow + queries ---
    pow_nonce = ch.grind(POW_BITS)
    positions = draw_query_positions(ch, log_size + LOG_BLOWUP, N_QUERIES)
    t = _stage(timings, "fri", t, dev)

    # --- assemble proof ---
    at = torch.as_tensor(positions, device=dev)
    p = StwoStreamProof(
        log_size=log_size, nonce=nonce, counter=counter, pt_hash=pt_hash,
        ct_hash=ct_hash, pow_bits=POW_BITS, log_blowup=LOG_BLOWUP,
        log_last_layer=0, n_queries=N_QUERIES)
    p.commitments = [EMPTY_ROOT, tree1.root, tree2.root]
    p.sampled_values = [[], [[v] for v in sampled_flat[:N_COLS]],
                        [[v] for v in sampled_flat[N_COLS:]]]
    p.decommitments = [[], merkle_decommit(tree1.layers, positions),
                       merkle_decommit(tree2.layers, positions)]
    p.queried_values = [[], lde[:, at].cpu().tolist(),
                        tree2_cols[:, at].cpu().tolist()]
    p.proof_of_work = pow_nonce

    def fri_layer_proof(values, tree, pos_list):
        known = sorted(set(pos_list))
        sibs = sorted(s for s in {q ^ 1 for q in known} if s not in known)
        all_pos = sorted(set(known) | set(sibs))
        return FriLayer(fri_witness=[values[s] for s in sibs],
                        hash_witness=merkle_decommit(tree.layers, all_pos),
                        commitment=tree.root), sorted({q // 2 for q in all_pos})

    p.first_layer, cur_pos = fri_layer_proof(*fri_layers[0], positions)
    p.inner_layers = []
    for vals_l, tree_l in inner:
        layer, cur_pos = fri_layer_proof(vals_l, tree_l, cur_pos)
        p.inner_layers.append(layer)
    p.last_layer_coeffs = [last_coeff]
    p.last_layer_log_size = 0
    _stage(timings, "openings", t, dev)
    return p


def _commit_qm31(values: list, device) -> stark_merkle.MerkleTree:
    """A FRI layer's tree: leaf i = blake2s of value i's 4 LE u32 (fri.py's
    qm31_leaf); K7a from DEVICE_MIN_LEAVES leaves on the card."""
    leaves = np.asarray(values, dtype=np.uint32).view(np.uint8)
    return stark_merkle.commit(leaves, device)


def _quotients(P_pt, gamma, sampled: torch.Tensor, lde: torch.Tensor,
               tree2_cols: torch.Tensor, log_size: int) -> list:
    """stwo's quotient column (quotients.py) at the 2n stored positions,
    as host QM31 tuples: -2u (c S - (A y + B)) / pair_vanishing(x, y), with
    S the gamma-weighted sum of all 33,288 columns and A, B the weighted
    sums of the line coefficients, on the values' device."""
    dev = lde.device
    Px, Py = P_pt
    Pcx, Pcy = F.conj(Px), F.conj(Py)
    c_const = F.sub(Pcy, Py)
    gp = qm31_powers(gamma, sampled.shape[0], dev)              # [J, 4]
    v = _q(sampled)
    conj_v = (v[0], (m31_neg(v[1][0]), m31_neg(v[1][1])))
    a = qm31_sub(conj_v, v)
    b = qm31_sub(qm31_mul(v, _const(c_const, dev)),
                 qm31_mul(a, _const(Py, dev)))
    g = _q(gp)
    A = _t(qm31_mul(g, a)).sum(0) % P31
    B = _t(qm31_mul(g, b)).sum(0) % P31
    S = (_qm31_dot(lde.T, gp[:N_COLS])
         + _qm31_dot(tree2_cols.T, gp[N_COLS:])) % P31        # [2n, 4]
    xs, ys, _, _ = _commit_domain_on(log_size, dev)
    Aq, Bq = _q(A), _q(B)
    ay_b = qm31_add(((m31_mul(Aq[0][0], ys), m31_mul(Aq[0][1], ys)),
                     (m31_mul(Aq[1][0], ys), m31_mul(Aq[1][1], ys))), Bq)
    num = qm31_sub(qm31_mul(_const(c_const, dev), _q(S)), ay_b)
    cy, cx = F.sub(Py, Pcy), F.sub(Pcx, Px)
    c0 = F.sub(F.mul(Px, Pcy), F.mul(Pcx, Py))
    den = _t(qm31_add(_q(torch.tensor(cy, device=dev) * xs[:, None] % P31),
                      _q(torch.tensor(cx, device=dev) * ys[:, None] % P31)))
    den = _q((den + torch.tensor(c0, device=dev)) % P31)
    quot = qm31_mul(qm31_mul(num, qm31_inv(den)),
                    _const((0, 0, P31 - 2, 0), dev))
    return _to_host(_t(quot))


def prove_stream_bytes(key, nonce, counter, plaintext, ciphertext, device=None,
                       timings: dict | None = None) -> bytes:
    """The proof's bincode bytes (``prove_stream``; timings adds
    ``encode``)."""
    proof = prove_stream(key, nonce, counter, plaintext, ciphertext,
                         device=device, timings=timings)
    t = time.perf_counter()
    raw = encode_stream_proof(proof)
    if timings is not None:
        timings["encode"] = time.perf_counter() - t
    return raw

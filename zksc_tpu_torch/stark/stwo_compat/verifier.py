"""Full replica of the reference stwo verifier for the chacha20 stream AIR.

Mirrors verify_chacha20_proof (wasm_api.rs) + verify_stream_internal
(air_stream.rs) + stwo::verify, byte-for-byte on the Fiat-Shamir channel.
The composition-consistency check (constraint evaluation at the OODS
point) is delegated to `air_eval` so the AIR replica can be developed and
validated independently; pass None to run the structural verification
only (schema, transcript, pow, Merkle decommitments, FRI).

Copied from the JAX package's ``stark/stwo_compat/verifier.py``, with
three structural checks the reference lacks, numbered among the five the
port adds (each rejects only proofs that no in-range statement's prover
emits):

  1. log_size above upstream's MAX_LOG_SIZE (24) or n_queries above
     MAX_QUERIES is rejected before the channel replay (the reference
     replays and then loops over them);
  3. queried_values and decommitments must hold three trees, so a
     decodable proof with fewer gives False instead of an IndexError;
  5. the constants after the config must be 1 and 0, and tree 0 (the empty
     preprocessed tree) must have no decommitment and no queried values,
     so an accepted proof has one encoding.

(Check 2 is the operator's 8 MB cap on the base64 text; check 4 the
prover's counter-overflow check.) It runs on the host: 3 queries and one
QM31 walk of the AIR at the OODS point.
"""
from __future__ import annotations

import hashlib
import struct

from . import field as F
from .channel import Blake2sChannel
from .circle import CanonicCoset
from .codec import StwoStreamProof, decode_stream_proof
from .fri import verify_fri
from .merkle import EMPTY_ROOT, leaf_hash, verify as merkle_verify
from .quotients import QuotientCombiner, oods_point

N_TRACE_COLS = 33280
N_COMP_COLS = 8
MAX_LOG_SIZE = 24          # upstream's (air_stream.rs:176)
MAX_QUERIES = 128          # stwo's default is 3; the prover's too


def draw_query_positions(ch: Blake2sChannel, log_domain: int,
                         n_queries: int) -> list:
    out = []
    while len(out) < n_queries:
        words = struct.unpack("<8I", ch.draw_random_bytes())
        for w in words:
            out.append(w & ((1 << log_domain) - 1))
            if len(out) == n_queries:
                break
    return sorted(set(out))


def default_air_eval(p: StwoStreamProof, P, random_coeff) -> bool:
    """OODS composition consistency: the chacha AIR constraints evaluated
    at the OODS point on the sampled trace values, accumulated with
    random_coeff and divided by the trace-domain vanishing pi^(log-1)(x),
    must equal the composition reconstruction sum_i u_i*(g_i + lam_i*V)."""
    from .air import accumulate, evaluate_constraints
    trace_samples = [tuple(c[0]) for c in p.sampled_values[1]]
    comp_samples = [tuple(c[0]) for c in p.sampled_values[2]]
    acc = accumulate(evaluate_constraints(trace_samples), random_coeff)
    Px = P[0]
    V = Px
    for _ in range(p.log_size - 1):
        V = F.sub(F.add(F.mul(V, V), F.mul(V, V)), F.ONE)
    lhs = F.mul(acc, F.inv(V))
    units = (F.ONE, (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1))
    rhs = F.ZERO
    for i in range(4):
        lam = comp_samples[4 + i]
        if lam[1] or lam[2] or lam[3]:
            return False                 # lambda columns must be M31
        coord = F.add(comp_samples[i], F.mul_m31(V, lam[0]))
        rhs = F.add(rhs, F.mul(units[i], coord))
    return lhs == rhs


def verify_stream_proof(proof: StwoStreamProof, nonce: bytes, counter: int,
                        plaintext: bytes, ciphertext: bytes,
                        air_eval=default_air_eval, min_pow_bits: int = 10,
                        min_blowup: int = 1, min_queries: int = 3) -> bool:
    p = proof
    # --- config floor + public input binding (air_stream.rs:291-359) ---
    if (p.pow_bits < min_pow_bits or p.log_blowup < min_blowup
            or p.n_queries < min_queries):
        return False
    if p.log_size > MAX_LOG_SIZE or p.n_queries > MAX_QUERIES:
        return False
    if p.const_u32 != 1 or p.const_u8 != 0:
        return False
    if p.nonce != nonce or p.counter != counter:
        return False
    if hashlib.blake2s(plaintext).digest() != p.pt_hash:
        return False
    if hashlib.blake2s(ciphertext).digest() != p.ct_hash:
        return False
    if len(p.commitments) != 3 or p.commitments[0] != EMPTY_ROOT:
        return False
    if (len(p.sampled_values) != 3 or p.sampled_values[0]
            or len(p.sampled_values[1]) != N_TRACE_COLS
            or len(p.sampled_values[2]) != N_COMP_COLS):
        return False
    if any(len(c) != 1 for t in p.sampled_values[1:] for c in t):
        return False
    if len(p.queried_values) != 3 or len(p.decommitments) != 3:
        return False
    if p.queried_values[0] or p.decommitments[0]:
        return False
    if (len(p.queried_values[1]) != N_TRACE_COLS
            or len(p.queried_values[2]) != N_COMP_COLS):
        return False

    # --- channel replay ---
    ch = Blake2sChannel()
    ch.mix_root(p.commitments[0])
    ch.mix_u64(p.log_size)
    for i in range(3):
        ch.mix_u64(struct.unpack_from("<I", p.nonce, 4 * i)[0])
    ch.mix_u64(p.counter)
    for i in range(8):
        ch.mix_u64(struct.unpack_from("<I", p.pt_hash, 4 * i)[0])
    for i in range(8):
        ch.mix_u64(struct.unpack_from("<I", p.ct_hash, 4 * i)[0])
    ch.mix_root(p.commitments[1])
    random_coeff = ch.draw_felt()
    ch.mix_root(p.commitments[2])
    oods_t = ch.draw_felt()
    P = oods_point(oods_t)
    sampled_flat = [tuple(q) for t in p.sampled_values for c in t for q in c]
    ch.mix_felts(sampled_flat)
    gamma = ch.draw_felt()
    alphas = []
    ch.mix_root(p.first_layer.commitment)
    alphas.append(ch.draw_felt())
    for l in p.inner_layers:
        ch.mix_root(l.commitment)
        alphas.append(ch.draw_felt())
    ch.mix_felts([tuple(q) for q in p.last_layer_coeffs])
    if not ch.check_pow(p.pow_bits, p.proof_of_work):
        return False

    # --- composition consistency at the OODS point ---
    if air_eval is not None:
        if not air_eval(p, P, random_coeff):
            return False

    # --- queries + tree decommitments ---
    log_dom = p.log_size + p.log_blowup
    positions = draw_query_positions(ch, log_dom, p.n_queries)
    nq = len(positions)
    if any(len(c) != nq for t in p.queried_values[1:] for c in t):
        return False
    for ti, n_cols in ((1, N_TRACE_COLS), (2, N_COMP_COLS)):
        leaves = {}
        for qi, pos in enumerate(positions):
            leaves[pos] = leaf_hash(
                [p.queried_values[ti][c][qi] for c in range(n_cols)])
        if not merkle_verify(leaves, p.decommitments[ti], log_dom,
                             p.commitments[ti]):
            return False

    # --- quotients + FRI ---
    comb = QuotientCombiner(P, gamma, sampled_flat)
    dom = CanonicCoset(log_dom).circle_domain()
    first_values = {}
    for qi, pos in enumerate(positions):
        colvals = ([p.queried_values[1][c][qi] for c in range(N_TRACE_COLS)]
                   + [p.queried_values[2][c][qi] for c in range(N_COMP_COLS)])
        first_values[pos] = comb.at(dom.at_stored(pos), colvals)
    return verify_fri(p, dom, positions, first_values, alphas)


def verify_stream_proof_bytes(raw: bytes, nonce: bytes, counter: int,
                              plaintext: bytes, ciphertext: bytes,
                              air_eval=default_air_eval) -> bool:
    try:
        p = decode_stream_proof(raw)
    except (ValueError, IndexError, struct.error):
        return False
    return verify_stream_proof(p, nonce, counter, plaintext, ciphertext,
                               air_eval=air_eval)

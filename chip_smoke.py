#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (zksc_tpu_torch) on one GPU.

    python3 chip_smoke.py               # all phases (one card)
    python3 chip_smoke.py --profile     # all phases + a torch.profiler
                                        # breakdown of one more proof
    python3 chip_smoke.py --toprf aes-128-ctr-toprf
                                        # phases 1, 2 and phase 8 (with its
                                        # phase 5 replay) for one -toprf
                                        # statement alone

Phases, each printing its elapsed seconds on a flushed line of its own:

  1. environment: torch / CUDA versions, the card, nvidia-smi name and
     power limit; fails without CUDA.
  2. build: the nvcc builds of the CUDA kernels (csrc/ec_kernels.cu ->
     build/libzksc_ec.so, csrc/msm_kernels.cu -> build/libzksc_msm.so,
     csrc/stark_kernels.cu -> build/libzksc_stark.so, csrc/h_kernels.cu ->
     build/libzksc_h.so, csrc/msm_glue.cu -> build/libzksc_msm_glue.so,
     the nvcc processes started together) and the g++ build of the
     witness-tape library, with
     their seconds; then, from ptxas, each kernel instance's registers,
     stack and spill bytes (K3: lane_kernel and split_kernel, each for Fp
     and Fp2h; K7a blake2s_kernel and blake2s_tree_kernel, K7b
     circle_fft_kernel<interp, B, threads> and circle_layer_kernel<interp,
     rev>, K7c composition_kernel<offset, points> and
     composition_finish_kernel, K7d aes_composition_kernel<offset, points>;
     the H kernels: K0 fr_elementwise_kernel<mode>, K4
     ntt_group_kernel<dif, dit>, K5 sparse_matvec_kernel; the MSM glue:
     K6a msm_keys_kernel<key, shared>, K6b pack_points_kernel and
     sorted_gather_kernel, K6c
     scan_top_kernel<F>, K6d segment_prefix_kernel<F>
     and bucket_kernel<F>).
  3. kernel vs plain at check sizes: K1 chunk_scan (G1, G2 x inclusive,
     exclusive, and the carry written for a next level; S=16, C=2,048 and
     an odd C=2,045) and K2 jac_add_n (G1, G2 x complete, incomplete;
     N=8,192 and an odd N=8,129, which leaves a G2 warp with an unpaired
     tail; and K2 on the two halves of one array, as the halving reduce
     passes them) on live points of the committed chacha20 proving key
     plus crafted lanes: identity, P = Q affine (the doubling through the
     affine-Q path), re-scaled, P = -Q, Q = O with P affine, and affine
     and Jacobian Q mixed inside one warp; K3 ladder in both layouts
     (LANE, SPLIT) x (G1, G2) x (unreduced with per-lane and shared bits,
     reduced over segments of 64 and of all lanes; N=4,096, 32 bits) with
     crafted zero and one scalars, identity points, Jacobian points, and
     equal and opposite points on lanes the reduction pairs, and at the
     ladder branch's shape (128 lanes x 254 bits, reduced over all 128) in
     both layouts, the wrapper's choice marked, each with its chain floor;
     each kernel must equal its plain PyTorch version limb for limb. K3
     over 254 bits on 8 lanes must equal curve/bn254_host's scalar
     products and their sum; both K3 layouts are timed over 1,024-65,536
     lanes x 32 bits (per-lane and shared bits, G1 and G2) beside the
     wrapper's pick (the crossover), and K3 at the ceremony's shape with a
     fixed 254-bit scalar beside its bound. K1 and K2 at the digit pattern of 254-bit
     wire scalars: every call of a 13-bit-window bucket MSM (20 windows,
     the top one 7 bits wide) over 4,096 lanes, and of its top window
     alone over 16,384 lanes (almost every bucket empty), G1 and G2,
     equal to the plain versions; and torch.sort(stable=True) over the 20
     x 131,072 keys of that shape gives the stable permutation.
     The bucket MSM's glue K6a-d (check_glue_kernels) at the chacha20
     proof's H MSM shape (G1, 65,536 points, 254-bit scalars, c = 13, W =
     20: 1,310,720 sorted lanes, a top of 5,120 lanes, 163,840 bucket
     lanes) and B2 MSM shape (G2, 40-bit scalars, c = 10, W = 4), with
     identity and duplicated points and 0 / 1 scalars: each K6 call of one
     _window_sums replayed through the kernel and its plain version (equal
     limb for limb), timed beside its bound (K6a: torch.sort of its keys
     beside it); the window sums equal those of the plain glue.
     The stark kernels, each equal to its plain version value for value:
     K7a Blake2s over 2,048 messages of 0, 1, 63, 64, 65 and 129,024 bytes
     read as the columns of a [words, 2,048] tensor, by the loose-message
     kernel and by the tree launch (one launch a Merkle tree), each tree
     equal to hashlib's layer for layer; the tree over 1-2,048 16-byte
     rows (FRI's leaves), equal to hashlib's; both launches timed at 1,024
     x 129,024 B and 32 x 133,120 B beside K7a's chain floor; K7b
     interpolate and evaluate at log N = 3, 6, 8, 10, 11, 16, 20 over 1
     column and over min(4,096, 2^28 / N) columns, with the round trip
     (one circle_fft launch up to 2^15, one circle_layer launch a layer
     above); K7b's circle_fft at every LDE shape of phases 9-11 (the
     chacha20 and both AES LDEs, evaluate from N + 50 coefficients
     rounded up to 4; stwo's) and at 2^15, each timed beside its bound and
     beside circle_layer's per-layer route on the same values, and an
     evaluate at 2^16 through circle_layer (16 launches); K7c at M = 1,024
     on the chacha20 AIR's index groups with random values; at the
     stark-stwo shapes, K7c on its AIR's groups at M = 32 and 512; K7d on
     the AES-128 and AES-256 AIRs' index groups at M = 2,048 (the 80-byte
     chunk) and 8,192 (the 16 KiB record), random values and challenges,
     sigma as the prover's, in the wrapper's plan (aes_composition_plan),
     timed beside its bound; each K7c line
     names the launch shape the wrapper picked (composition_plan).
     The Groth16 H kernels, each equal to its plain version limb for limb
     (check_h_kernels): K0 (to_mont, the quotient, the pack of z and both
     halves of both cross stages) over 8,191 elements, K4 every transform
     form at 2^8 and 2^10 with a 2^4 tile (two and three launches a
     direction) and at 2^11 in one group, K5 over 1,000 rows with empty,
     300-term and 1,500-term rows (its three bins) and every coefficient
     class; then at n = 2^16, 2^17 and 2^18 with k = 1 and 4: to_mont of
     [16, k, n], K5 over a random CSR of n rows, K4's coset pass over
     [16, 3k, n] in the tile picked from the grid, the quotient over
     [16, 3, k, n] and K4's way back with from_mont over [16, k, n], each
     timed beside its bound (K5: both bounds, a product a term and the
     classes' work).
     Then the Merkle crossover: whole trees of 4-4,096 16-byte leaves or 8-word
     column leaves by hashlib and by K7a's tree launch (with its copies),
     host clock.
  4. main path at full size: api.generate_proof("chacha20", ...) twice on
     a 128-byte chunk with the committed artifacts/chacha20 key (45,217
     wires, domain 2^16); api.verify_proof must accept it and reject a
     ciphertext with one byte flipped; the launch counters of K1, K2 and
     the H kernels K0, K4, K5 (reset just before the second proof) must
     be > 0, and those of K6a-d. Then the five MSMs of a warm chacha20
     proof (tools/msm_stage_torch.py) replayed under
     torch.cuda.set_sync_debug_mode("error"): no synchronising call, and
     their kernel launch calls under torch.profiler at most
     MSM_STAGE_MAX_LAUNCHES (300), printed beside the parent commit's
     count (a recorded constant, MSM_STAGE_PARENT_LAUNCHES).
  6. keys made on the card, at full width: the aes-128-ctr and aes-256-ctr
     circuits compile to the digests of the committed manifests; keygen
     for aes-128-ctr (fixed --seed) into the port's key store; load_keys;
     one ceremony contribution (K3 over h_query and c_query), checked by
     verify_chain and verify_query_scaling; the contributed key saved to
     the store; api.generate_proof of an 80-byte aes-128-ctr chunk twice
     (cold, warm); verify_proof accepts it and rejects a flipped byte. The
     launch counters are reset just before keygen and K1, K2, K3, K0, K4
     and K5 must all be > 0 after the proofs. Seconds per stage and peak device memory.
  7. the ladder branch of ProverContext on the card: the x^13 toy circuit
     (m_pad 32: host B2, K3 for G1) and a 100-power circuit (m_pad 128: K3
     for G1 and G2), keys from the port's setup on the card; each proof
     verifies and equals the force_pippenger proof under the same rng; K3's
     counter, reset just before, must be > 0.
  8. the TOPRF statements: the three -toprf circuits compile to the
     digests of the committed manifests; keygen for chacha20-toprf (fixed
     --seed, 91,001 wires, domain 2^17) into the port's key store; a host
     TOPRF round through the port's OPRFOperator (threshold keys n=3,
     t=2, a request over a redacted span of a 128-byte plaintext,
     evaluations by two shares, finalise); api.generate_proof(...,
     toprf=, mask=) with the key made here, cold, warm (launch counters
     reset just before it, K1, K2, K0, K4 and K5 must be > 0; stage
     seconds, peak device memory) and once more for phase 5; verify_proof accepts the
     warm proof, whose envelope carries no plaintext, and rejects a
     flipped ciphertext byte, the TOPRF output plus one and the other
     share's response.
  9. the stark engine (chacha20, Circle STARK over M31): api.generate_proof(
     "chacha20", ..., engine="stark") on a 128-byte chunk, cold, warm (the
     launch counters reset just before it, K7a, K7b and K7c must all be >
     0 and K7b exactly 2, one a transform; stage seconds and peak device
     memory) and once more for phase 5;
     api.verify_proof(..., engine="stark") accepts it and rejects a flipped
     ciphertext byte and a flipped byte inside the bincode payload;
     stark.prover.prove_stream on a 16 KiB record (256 blocks) twice (the
     second with the same checks) and once more for phase 5, and
     verify_stream; the 128-byte chunk proved on the card and on the CPU
     (plain versions, hashlib) under one seeded rand_bytes: the two
     envelopes must be equal byte for byte.
 10. the stark engine for aes-128-ctr and aes-256-ctr (the LogUp S-box
     AIR): for each key size, api.generate_proof(..., engine="stark") on
     an 80-byte chunk cold, warm (the launch counters reset just before
     it, K7a, K7b and K7d must all be > 0, K7b exactly 4; stage seconds,
     peak device memory, envelope size) and, for aes-128-ctr, once more
     for phase 5;
     verify_proof(..., engine="stark") accepts it and rejects a flipped
     ciphertext byte and a flipped byte of the bincode payload;
     stark.aes_prover.prove_aes_ctr on a 16 KiB record (1,024 blocks, N =
     1,024, M = 8,192) twice with the same checks (aes-256-ctr once more
     for phase 5) and verify_aes_ctr; the aes-128-ctr chunk proved on the
     card and on the CPU under one seeded rand_bytes: the envelopes must
     be equal byte for byte.
 11. the stark-stwo engine (chacha20, byte-identical stwo proofs): the two
     committed upstream proofs (tests/fixtures/stwo_ref_proof_chacha_ls4 /
     _ls5) proved on the card, each equal to the fixture byte for byte;
     api.generate_proof("chacha20", ..., engine="stark-stwo") on a
     128-byte chunk cold, warm (the launch counters reset just before it,
     K7a, K7b and K7c must all be > 0, K7b exactly 3; stage seconds, peak
     device memory, envelope size) and once more for phase 5 (equal
     bytes); verify_proof(
     ..., engine="stark-stwo") accepts it and rejects a flipped ciphertext
     byte and a flipped byte of the base64 payload; prove_stream_bytes on
     a 16 KiB record (256 blocks, log size 8) twice with the same checks
     and once more for phase 5, verified by the port's stwo verifier (a
     flipped ciphertext byte rejected); the record proved on the CPU
     (plain versions, hashlib): equal to the card's byte for byte; the
     host tables a first proof builds (the AIR's layout, each log size's
     domains and row maps) rebuilt and timed.
 12. the interop layer at full width: phase 4's warm chacha20 proof and
     the committed key through gnark's binary proof and verifying key and
     the snarkjs vkey JSON and back (the proof verifies under both
     imported vks, a flipped ciphertext byte is rejected under both), its
     witness as a .wtns read back equal; the key's .zkey (seconds per
     section, size, peak device memory), read back (the B2 query's
     subgroup check as one K3 ladder on the card) equal to the key's
     host-affine points and A/B rows, a B2 point outside the subgroup
     rejected; a gnark v0.14 .r1cs written here (gnark_toy_r1cs: a packed
     intcomp block, an nBits hint) parsed, solved, set up, proved and
     verified on the card, a tampered public input rejected (K1/K2/K3
     launches printed, K2 and K3 > 0); the AES-256 CTR keystream of a 16
     KiB record (1,024 blocks) made on the card equal to the host's; Fr
     inv, mont_pow and mont_sqr over 2^16 elements equal to Python ints;
     trace_span around one warm chacha20 proof with ZKSC_TRACE_DIR under
     chiprun_out/: the trace's size and CUDA kernel events (the file is
     removed after reading when over 16 MiB).
 13. the multi-device layer on the one card: the committed chacha20 key's
     ProverContext on meshes of D = 2 and D = 4 shards (make_mesh(D): D
     shards on the card, run one after another, so the seconds printed
     beside the one-device stages are the layer's overhead, not a
     speed-up): the sharded H limbs equal the one-device limbs, the proof
     under a fixed rng equals the one-device proof, verifies, and a
     flipped ciphertext byte is rejected; K1, K2, K0, K4 and K5 launch
     counts, reset just before, > 0 (the sharded H on the kernels: each
     shard's row slice through K5, the local stages through K4, the
     exchanged stages and the quotient through K0), and the sharded H's
     launch calls under torch.profiler at most MESH_H_MAX_LAUNCHES (150),
     which no eager Fr op would fit under; the D = 4 proof's H calls are
     recorded for phase 5. ShardedNTT over 8 shards at 2^16 and 2^18, each
     transform (and the two the H pass runs) equal to NTTContext's. The x^100 circuit of phase 7 on a
     mesh of 4 (one K3 ladder a shard, partial sums added on the host):
     equal to the one-device proof, K3 > 0. Two processes (this script
     with --mesh-worker PID PORT) under parallel.multihost.initialize
     (gloo, the card's blocks staged through the host): the 4-shard
     global mesh's ShardedNTT equals the one-device transform, each
     process proves its host_slice of 4 chacha20 requests, and this
     process verifies all 4. The port's tools as subprocesses, output
     printed and exit code checked: profile_prove_torch.py 2,
     bench_stark_torch.py at log 6 and 64 AES blocks,
     gen_oneblock_artifacts_torch.py followed by one proof with its key,
     and the two that need the reference checkout, which must exit
     non-zero naming the missing file.
 14. the batched Groth16 path (ProverContext._h_pipeline_batch: one H
     pass for k proofs; the witnesses built on min(4, k) threads):
     api.generate_proofs("chacha20", ...) over k = 1, 2 and 4 consecutive
     128-byte chunks of one stream with the committed key, and
     aes-128-ctr over k = 4 80-byte chunks with phase 6's contributed key;
     each k twice (first at this k, then warm: launch counters reset just
     before, K1, K2, K0, K4 and K5 > 0; stage seconds, peak device memory), k = 4 once
     more with its kernel calls recorded for phase 5; every proof of the
     warm batch verifies and rejects a flipped ciphertext byte;
     compute_h_batch at each k equals the per-proof _h_core limb for limb,
     and its kernel launches (the host's launch calls under torch.profiler)
     are at most H_MAX_LAUNCHES (200) at every k, and at k = 4 at most
     1.01x those at k = 1.
  5. kernel timing at the paths' shapes (run last, as it replays phases 4,
     6, 7, 8, 9, 10, 11 and 14): the first of the largest inputs each kernel
     variant got in
     each path is replayed through the kernel and its plain version (equal
     limb for limb; for K3 over more than 128 lanes the plain version runs
     on a sample of an unreduced input's lanes that reaches every block of
     128), timed with CUDA events (card-only: a sleep kernel is queued
     first; the host-paced time beside it), and set beside its bound (IMAD
     count or bytes, from these inputs; an add with affine Q counts 11
     products, G2 three base products per Fp2 product); a K3 row also
     names the layout the wrapper picked and its chain floor (the longest
     warp's product rounds x 258 IMAD x 2 cycles / SM clock). Then every kernel
     call of one warm chacha20 and one warm aes-128-ctr proof is replayed
     in order: per kernel the launches, the summed ms, the summed bound and
     the adds whose Q is affine, which also go into the kernels line;
     likewise for the recorded chacha20-toprf proof of phase 8 and phase
     14's warm k = 4 batches. The K6 kernels of the same runs likewise:
     each variant's largest call replayed through the kernel and its plain
     version (equal), timed beside its bound (bytes; point adds x Fp
     products x 258 IMAD), then every K6 call of each run summed per
     kernel (launches, card ms, host-paced ms, bound). The H kernels (K0,
     K4, K5) of the same
     chacha20, aes-128-ctr, chacha20-toprf and k = 4 runs and of phase
     13's D = 4 mesh proof: each variant's
     largest call replayed through the kernel and its plain version
     (equal), timed beside its bound (Fr products x 258 IMAD over the
     card's rate, or the bytes read once and written once over HBM; K5
     both ways: a product a term, and the classes' work, where only a wide
     coefficient's term costs a product), then every H call of each run
     summed per kernel. For the
     stark engine's warm proofs (phase 9's chacha20 chunk and record, phase
     10's aes-128-ctr chunk and aes-256-ctr record, phase 11's stark-stwo
     chunk and record): the largest call of each K7
     instance replayed through the kernel and its plain version (equal),
     timed and set beside its bound (the larger of integer operations over
     the card's rate and the bytes read once and written once over HBM),
     then every K7 call of each proof, summed per kernel (K7a's tree
     launches under K7a, K7b's circle_fft under K7b); each K7a line adds
     its chain floor (a message's
     chained compressions, and a node a layer for a tree, x
     BLAKE2S_CHAIN_CLOCKS over the SM clock).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Any failure raises (exit code != 0).
Imports nothing of JAX and nothing of the JAX package.
"""
import json
import os
import subprocess
import sys
import time

T0 = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM: 32-bit integer multiply-add throughput per SM per clock (CUDA C
# programming guide, arithmetic instruction throughput, compute capability
# 9.0) and HBM3 bandwidth (NVIDIA data sheet).
IMAD_PER_CLK_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
# IMAD issue slots per Montgomery product in csrc/bn254.cuh: 2 x 64 wide
# multiply-adds (a*b and m*p) + 1 for m, each 32x32->64 product two slots
IMAD_PER_FP_MUL = 2 * (64 + 64 + 1)
# Fp products per point operation, G1 / G2 (Karatsuba's 3 per Fp2 product,
# though the G2 kernels issue 4: the yardstick never flatters them)
FP_MULS_PER_ADD = {False: 16, True: 48}   # point add, Jacobian Q
FP_MULS_PER_ADD_AFFINE = {False: 11, True: 33}   # Q.z = 1: no products by Z2
FP_MULS_PER_DBL = {False: 7, True: 21}    # point doubling


def log(msg: str):
    print(f"[{time.time() - T0:8.2f} s] {msg}", flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(text: str):
    """[(kernel, registers, stack bytes, spill store bytes, spill load
    bytes)] of each entry function in nvcc -Xptxas -v output; names
    demangled by c++filt where it is installed."""
    import re
    rows, name, frame = [], None, (0, 0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(map(int, m.groups()))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append([name, int(m.group(1)), *frame])
            name, frame = None, (0, 0, 0)
    try:
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, n in zip(rows, names):
                r[0] = n.split("(")[0]
    except OSError:
        pass
    return [tuple(r) for r in rows]


def cuda_ms(fn, reps: int, paced: bool = False) -> float:
    """Mean ms per call between CUDA events around `reps` calls after a
    warm-up. By default a sleep kernel queued first keeps the card busy
    while the host queues the calls, so the time is the card's alone; with
    paced=True the card waits for the host between calls, as on the path
    (a sub-0.1 ms kernel then measures the wrapper's launch rate)."""
    import torch
    fn()                                   # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not paced:
        torch.cuda._sleep(20_000_000)      # ~10 ms at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_diff(a_list, b_list) -> int:
    err = 0
    for a, b in zip(a_list, b_list):
        assert a.shape == b.shape, (a.shape, b.shape)
        err = max(err, int((a.long() - b.long()).abs().max().item()))
    return err


# ------------------------------------------------------------- test points

def load_points(device):
    """G1 (a and b1 queries) and G2 (b2 query, its six component arrays)
    points of the committed chacha20 proving key, each cut to the lanes
    that are not the identity, so that every crafted lane is a live add."""
    import numpy as np
    import torch
    from zksc_tpu_torch.ops.ec import JacPoint
    path = os.path.join(HERE, "artifacts", "chacha20", "pk.npz")
    with np.load(path) as d:
        def t(k, live):
            return torch.from_numpy(d[k][:, live].astype(np.int32)).to(device)
        live = lambda k: (d[k] != 0).any(0)
        la, lb = live("a_z"), live("b1_z")
        g1a = JacPoint(*(t("a_" + c, la) for c in "xyz"))
        g1b = JacPoint(*(t("b1_" + c, lb) for c in "xyz"))
        l2 = live("b2_z0") | live("b2_z1")
        g2 = [t("b2_" + k, l2) for k in ("x0", "x1", "y0", "y1", "z0", "z1")]
    return g1a, g1b, g2


def _wrap(n_src: int, lo: int, hi: int, device):
    """Lanes lo..hi-1 of a source of n_src lanes, taken cyclically."""
    import torch
    return torch.arange(lo, hi, device=device) % n_src


def g2_lanes(g2_halves, lo: int, hi: int):
    """Folded G2 JacPoint of lanes [lo, hi) (cyclic) of the six component
    arrays."""
    import torch
    from zksc_tpu_torch.ops.ec import JacPoint
    idx = _wrap(g2_halves[0].shape[1], lo, hi, g2_halves[0].device)
    h = [a[:, idx] for a in g2_halves]
    cat = lambda a, b: torch.cat([a, b], dim=-1).contiguous()
    return JacPoint(cat(h[0], h[1]), cat(h[2], h[3]), cat(h[4], h[5]))


def g1_lanes(P, lo: int, hi: int):
    from zksc_tpu_torch.ops.ec import JacPoint
    idx = _wrap(P.x.shape[1], lo, hi, P.x.device)
    return JacPoint(*(a[:, idx].contiguous() for a in P))


def craft(fops, P, Q, seed: int):
    """Overwrite lane groups of (P, Q) with the edge cases of point addition:
    Q = P (both affine, as the key's points are: the doubling branch through
    the affine-Q path), Q = P re-scaled (same point, other Jacobian
    representative), Q = -P (both affine), P = O, Q = O (P affine),
    P = Q = O, and Q re-scaled on odd lanes only (affine and Jacobian Q
    mixed inside one warp). Returns new (P, Q)."""
    import torch
    from zksc_tpu_torch.fields.limb import Fp
    from zksc_tpu_torch.ops import ec
    from zksc_tpu_torch.ops.ec import JacPoint
    g2 = isinstance(fops, ec.Fp2Ops)
    n = fops.lane_width(P.x)
    G = 64
    assert n >= 7 * G
    gen = torch.Generator().manual_seed(seed)
    lam = Fp.to_device([int(v) + 2 for v in torch.randint(
        0, 2**62, (G,), generator=gen)], device=P.x.device)
    if g2:
        lam = torch.cat([lam, torch.zeros_like(lam)], dim=-1)  # lambda in Fp
    ident = ec.jac_identity_batch(fops, (G,), device=P.x.device)

    def lanes(A, g):
        return JacPoint(*(fops.lane_map(lambda a: a[:, g * G:(g + 1) * G], c)
                          for c in A))

    def put(A, g, B):
        out = []
        for a, b in zip(A, B):
            a = a.clone()
            if g2:
                a[:, g * G:(g + 1) * G] = b[:, :G]
                a[:, n + g * G:n + (g + 1) * G] = b[:, G:]
            else:
                a[:, g * G:(g + 1) * G] = b
            out.append(a)
        return JacPoint(*out)

    p0, p1 = lanes(P, 0), lanes(P, 1)
    Q = put(Q, 0, p0)                                         # Q = P
    l2 = fops.mul(lam, lam)
    Q = put(Q, 1, JacPoint(fops.mul(p1.x, l2), fops.mul(p1.y, fops.mul(l2, lam)),
                           fops.mul(p1.z, lam)))              # Q = P, rescaled
    p2 = lanes(P, 2)
    Q = put(Q, 2, JacPoint(p2.x, fops.neg(p2.y), p2.z))       # Q = -P
    P = put(P, 3, ident)                                      # P = O
    Q = put(Q, 4, ident)                                      # Q = O
    P = put(P, 5, ident)
    Q = put(Q, 5, ident)                                      # P = Q = O
    q6 = lanes(Q, 6)
    odd = (torch.arange(G, device=P.x.device) % 2 == 1)
    sel = lambda a, b: fops.select(odd, a, b)
    Q = put(Q, 6, JacPoint(sel(fops.mul(q6.x, l2), q6.x),
                           sel(fops.mul(q6.y, fops.mul(l2, lam)), q6.y),
                           sel(fops.mul(q6.z, lam), q6.z)))  # mixed Q
    return P, Q


# ------------------------------------------------------------- bounds

def nonid(fops, P):
    """bool [lanes]: point is not the identity."""
    return ~fops.is_zero(P.z)


def z_is_one(z0, z1=None, dim=0):
    """bool: the Z coordinate (limb axis `dim`; G2: components z0, z1)
    equals Montgomery one, i.e. the point is affine."""
    import torch
    from zksc_tpu_torch.fields.limb import Fp
    one = torch.as_tensor(Fp.to_device([1]).reshape(-1), device=z0.device)
    one = one.reshape([-1] + [1] * (z0.dim() - 1 - dim))
    ok = (z0 == one).all(dim)
    if z1 is not None:
        ok = ok & (z1 == 0).all(dim)
    return ok


def _bound(imad, nbytes, imad_rate):
    t_ops, t_bytes = imad / imad_rate, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def add_imad(g2, adds, affine):
    """IMAD slots of `adds` point adds of which `affine` have Q.z = 1."""
    return ((adds - affine) * FP_MULS_PER_ADD[g2]
            + affine * FP_MULS_PER_ADD_AFFINE[g2]) * IMAD_PER_FP_MUL


def k2_bound_ms(fops, P, Q, imad_rate):
    """Adds that these inputs need: lanes where neither point is the
    identity, with 11 (G2 33) products where Q is affine. Returns (ms, by,
    adds, affine adds)."""
    from zksc_tpu_torch.ops import ec, ec_kernels
    g2 = isinstance(fops, ec.Fp2Ops)
    P, Q = ec_kernels.folded(fops, P), ec_kernels.folded(fops, Q)
    n = fops.lane_width(P.x)
    live = nonid(fops, P) & nonid(fops, Q)
    z = Q.z
    aff = live & (z_is_one(z[:, :n], z[:, n:]) if g2 else z_is_one(z))
    adds, affine = int(live.sum().item()), int(aff.sum().item())
    nbytes = 3 * 3 * (2 if g2 else 1) * 16 * 4 * n   # 2 points in, 1 out
    return (*_bound(add_imad(g2, adds, affine), nbytes, imad_rate), adds,
            affine)


def k1_steps(fops, pts, S):
    """Z of K1's step-major inputs as [S, 16, C] per component (G2: z0,
    z1)."""
    from zksc_tpu_torch.ops import ec, ec_kernels
    z = ec_kernels.folded(fops, pts).z
    halves = [z[:, :z.shape[1] // 2], z[:, z.shape[1] // 2:]] \
        if isinstance(fops, ec.Fp2Ops) else [z]
    return [h.reshape(16, S, -1).transpose(0, 1) for h in halves]


def k1_bound_ms(fops, pts, S, imad_rate):
    """Adds that these inputs need: per lane, every non-identity input after
    the first one (adding the identity, or to it, needs no product), with 11
    (G2 33) products where the input is affine. Returns (ms, by, adds,
    affine adds)."""
    import torch
    from zksc_tpu_torch.ops import ec
    g2 = isinstance(fops, ec.Fp2Ops)
    zs = k1_steps(fops, pts, S)
    C = zs[0].shape[2]
    nz = (zs[0] != 0).any(1)
    for z in zs[1:]:
        nz = nz | (z != 0).any(1)                       # [S, C]
    counted = nz & (torch.cumsum(nz.to(torch.int32), 0) > 1)
    aff = counted & z_is_one(*zs, dim=1)
    adds, affine = int(counted.sum().item()), int(aff.sum().item())
    nbytes = 3 * (2 if g2 else 1) * 16 * 4 * C * (2 * S + 1)  # in, out, carry
    return (*_bound(add_imad(g2, adds, affine), nbytes, imad_rate), adds,
            affine)


def k3_bound_ms(fops, P, bits, n_bits, seg, imad_rate):
    """What these inputs need: per lane with P != O and s != 0, one doubling
    for every bit below the top set bit and one addition for every set bit
    after it (11 products, G2 33, where P is affine); per segment one
    addition for each nonzero lane result after the first. Returns (ms, by,
    point ops, affine adds)."""
    import torch
    from zksc_tpu_torch.ops import ec
    g2 = isinstance(fops, ec.Fp2Ops)
    n = fops.lane_width(P.x)
    b = (bits != 0).to(torch.int64)
    if b.dim() == 1:
        b = b[:, None].expand(n_bits, n)
    pop = b.sum(0)
    top = (b * torch.arange(n_bits, device=b.device)[:, None]).max(0).values
    live = nonid(fops, P) & (pop > 0)
    aff = live & (z_is_one(P.z[:, :n], P.z[:, n:]) if g2 else z_is_one(P.z))
    dbls = int(torch.where(live, top, 0).sum().item())
    adds = int(torch.where(live, pop - 1, 0).sum().item())
    affine = int(torch.where(aff, pop - 1, 0).sum().item())
    if seg is not None:
        per_seg = live.reshape(-1, seg).sum(1)
        adds += int((per_seg - 1).clamp(min=0).sum().item())
    imad = dbls * FP_MULS_PER_DBL[g2] * IMAD_PER_FP_MUL \
        + add_imad(g2, adds, affine)
    words = 3 * 16 * (2 if g2 else 1)
    n_out = n if seg is None else n // seg
    nbytes = 4 * (words * (n + n_out) + bits.numel())
    return (*_bound(imad, nbytes, imad_rate), adds + dbls, affine)


# The product rounds on a K3 lane's critical path (csrc/msm_kernels.cu): a
# doubling, and what an add after it adds for an affine / a Jacobian point.
# LANE runs jac_double and jac_add one product after another; SPLIT runs a
# round of up to msm_kernels.ROLES products per level of split_step, three
# for the doubling and three more for the add. A G2 product is two base
# products per thread; a LANE reduction level one 16-product add.
K3_ROUNDS = {"LANE": (7, 11, 16), "SPLIT": (3, 3, 3)}
K3_REDUCE_ROUNDS = 16


def k3_layouts():
    """{layout: name} of K3's layouts (ops/msm_kernels.py)."""
    from zksc_tpu_torch.ops import msm_kernels
    return {msm_kernels.LANE: "LANE", msm_kernels.SPLIT: "SPLIT"}


def k3_chain_ms(fops, P, bits, n_bits, seg, layout, imad_rate):
    """The dependency floor of one K3 call in `layout`: the longest warp's
    chain of product rounds -- a warp runs a doubling at a bit where one of
    its lanes doubles (every bit below the lane's top set bit) and an
    addition where one of its lanes adds (every set bit after the top one;
    both kinds where affine and Jacobian points add) -- plus the LANE
    reduction's adds (16 products per halving level); each product 258
    IMAD at 2 issue cycles per warp, over the SM clock (G2: two base
    products per Fp2 product and thread). Returns (ms, rounds)."""
    import torch
    from zksc_tpu_torch.ops import ec, msm_kernels
    g2 = isinstance(fops, ec.Fp2Ops)
    n = fops.lane_width(P.x)
    threads = (2 if g2 else 1) * (msm_kernels.ROLES if layout == msm_kernels.SPLIT
                                  else 1)                  # per lane
    per_warp = 32 // threads
    b = (bits != 0)
    if b.dim() == 1:
        b = b[:, None].expand(n_bits, n)
    k = torch.arange(n_bits, device=b.device)[:, None]
    top = torch.where(b, k, -1).max(0).values                  # -1: s = 0
    live = nonid(fops, P) & (top >= 0)
    aff = z_is_one(P.z[:, :n], P.z[:, n:]) if g2 else z_is_one(P.z)
    dbl = live & (k < top)                                     # [n_bits, n]
    add = dbl & b
    pad = -n % per_warp

    def any_warp(m):                                           # [n_bits, warps]
        m = torch.nn.functional.pad(m, (0, pad))
        return m.reshape(n_bits, -1, per_warp).any(2).to(torch.int64)
    r_dbl, r_aff, r_jac = K3_ROUNDS[k3_layouts()[layout]]
    chain = (any_warp(dbl) * r_dbl + any_warp(add & aff) * r_aff
             + any_warp(add & ~aff) * r_jac).sum(0)
    rounds = int(chain.max().item()) if n else 0
    s = 1 if seg is None else seg
    while s > 1:
        g = min(s, msm_kernels.GROUP)
        rounds += (g.bit_length() - 1) * K3_REDUCE_ROUNDS
        s //= g
    props = torch.cuda.get_device_properties(0)
    clk_hz = imad_rate / (IMAD_PER_CLK_PER_SM * props.multi_processor_count)
    mult = 2 if g2 else 1
    return rounds * mult * IMAD_PER_FP_MUL * 2 / clk_hz * 1e3, rounds


# ------------------------------------------------------------- phases

def compare(label: str, run, plain, flat):
    """Kernel vs its plain version on the same inputs: exact equality, the
    kernel's ms (CUDA events) and the plain version's ms (host clock, one
    run). Raises on any difference."""
    import torch
    got = flat(run())
    torch.cuda.synchronize()
    t = time.time()
    want = flat(plain())
    torch.cuda.synchronize()
    plain_ms = (time.time() - t) * 1e3
    err = max_abs_diff(got, want)
    if err:
        raise AssertionError(f"{label}: kernel != plain (max_abs_err {err})")
    return cuda_ms(run, reps=5), plain_ms, err


def k1_input(fops, A, B, C: int, S: int):
    """K1's step-major input of C chunks: lanes 2i and 2i + 1 of chunk
    order (steps 2t, 2t + 1 of a chunk) hold A_i and B_i, so each crafted
    pair (A_i, B_i) meets as acc + Q in consecutive steps."""
    import torch
    from zksc_tpu_torch.ops import ec
    half = C * S // 2

    def layout(a, b):                       # one component, [16, >= half]
        pm = torch.stack([a[:, :half], b[:, :half]], dim=-1).reshape(16, C, S)
        return pm.transpose(1, 2).reshape(16, C * S).contiguous()
    out = []
    for a, b in zip(A, B):
        if isinstance(fops, ec.Fp2Ops):
            m = a.shape[1] // 2
            out.append(torch.cat([layout(a[:, :m], b[:, :m]),
                                  layout(a[:, m:], b[:, m:])], dim=-1))
        else:
            out.append(layout(a, b))
    return ec.JacPoint(*out)


def check_kernels(g1a, g1b, g2h, imad_rate, N=8192, S=16, C=2048):
    """Phase 3: K1 and K2 vs their plain versions at check sizes, on crafted
    lanes (craft), at a lane count that fills whole blocks and at an odd one
    that does not (a ragged last block, and an unpaired warp tail for the
    two-thread G2 instances)."""
    import torch
    from zksc_tpu_torch.ops import ec, ec_kernels, msm
    err = 0

    def check(label, name, fops, args):
        kern, plain = kernel_fns(name)
        ms, plain_ms, e = compare(label, lambda: kern(fops, *args),
                                  lambda: plain(fops, *args),
                                  lambda r: flat_result(name, r))
        _, _, ops, affine = bound_of(name, fops, args, imad_rate)
        log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
            f"{ops} adds ({affine} with affine Q), max_abs_err={e}")
        return e

    for g2 in (False, True):
        fops = ec.G2_OPS if g2 else ec.G1_OPS
        tag = "G2" if g2 else "G1"
        if g2:
            P, Q = g2_lanes(g2h, 0, N), g2_lanes(g2h, N, 2 * N)
        else:
            P, Q = g1_lanes(g1a, 0, N), g1_lanes(g1b, 0, N)
        P, Q = craft(fops, P, Q, seed=1 + g2)
        for n in (N, N - 63):
            cut = lambda A: ec.JacPoint(*(fops.lane_map(
                lambda a: a[:, :n].contiguous(), c) for c in A))
            for complete in (True, False):
                err = max(err, check(
                    f"K2 jac_add_n {tag} complete={complete} N={n}",
                    "jac_add_n", fops, (cut(P), cut(Q), complete)))
        # K2 on views, as the halving reduce passes them: the two halves
        # of one array, read in place (G2: [16, 2, n] views of the folded
        # layout); equal to the dense call and to the plain version
        def join(p, q):                     # lanes [P | Q], native layout
            if not g2:
                return torch.cat([p, q], dim=-1)
            return torch.cat([p[:, :N], q[:, :N], p[:, N:], q[:, N:]], dim=-1)
        W = ec.JacPoint(*(join(p, q) for p, q in zip(P, Q)))
        lo, hi = msm._lane_range(fops, W, 0, N), msm._lane_range(fops, W, N, 2 * N)
        dense = ec_kernels.jac_add_n(fops, P, Q, True)
        got = ec_kernels.jac_add_n(fops, lo, hi, True)
        e = max_abs_diff(list(got), list(dense))
        if e:
            raise AssertionError(f"K2 {tag} on views != dense (max_abs_err {e})")
        err = max(err, check(f"K2 jac_add_n {tag} complete=True on views N={N}",
                             "jac_add_n", fops, (lo, hi, True)))
        # K1 input: C chunks of S steps, step-major (lane = step * C +
        # chunk); crafted pairs land in consecutive steps of one chunk
        M = C * S
        if g2:
            A, B = g2_lanes(g2h, 0, M), g2_lanes(g2h, M, 2 * M)
        else:
            A, B = g1_lanes(g1a, 0, M), g1_lanes(g1b, 0, M)
        A, B = craft(fops, A, B, seed=3 + g2)
        for c in (C, C - 3):
            pts = k1_input(fops, A, B, c, S)
            for inclusive, steps in ((True, 1), (False, 1), (True, S)):
                if c % steps:
                    continue
                err = max(err, check(
                    f"K1 chunk_scan {tag} inclusive={inclusive} S={S} C={c}"
                    + (f" carry for a next level of {steps}" if steps > 1 else ""),
                    "chunk_scan", fops, (pts, S, inclusive, steps)))
    return err


def ladder_inputs(fops, P, n_bits: int, seed: int):
    """Per-lane bits with crafted lanes: scalar 0 (lane 0), scalar 1
    (lane 1), identity points with scalars 1 and random (lanes 2, 3); lanes
    4 and 68 (and 6 and 38) the same point and scalar, lanes 5 and 69 (and
    7 and 39) opposite points under one scalar: the first reduction round
    adds lane t + 64 to lane t in groups of 128 lanes and lane t + 32 in
    segments of 64, so these pairs meet as P + P and P + (-P); lanes 8-11
    hold Jacobian representatives (Z != 1) of their points, so the ladder's
    adds take the 16-product path there."""
    import torch
    from zksc_tpu_torch.fields.limb import Fp
    from zksc_tpu_torch.ops import ec
    from zksc_tpu_torch.ops.ec import JacPoint
    g2 = isinstance(fops, ec.Fp2Ops)
    n = fops.lane_width(P.x)
    gen = torch.Generator().manual_seed(seed)
    bits = torch.randint(0, 2, (n_bits, n), generator=gen, dtype=torch.int32)
    bits[:, 0] = 0
    bits[:, 1] = 0
    bits[0, 1] = 1
    bits[:, 2] = 0
    bits[0, 2] = 1
    for lane, src in ((68, 4), (69, 5), (38, 6), (39, 7)):
        bits[:, lane] = bits[:, src]
    coords = [a.clone() for a in P]

    def put(lane, src, neg=False):
        for i, a in enumerate(coords):
            val = a[:, src] if not g2 else a[:, [src, n + src]]
            if neg and i == 1:
                val = Fp.neg(val)
            if g2:
                a[:, [lane, n + lane]] = val
            else:
                a[:, lane] = val
    put(68, 4)
    put(69, 5, neg=True)
    put(38, 6)
    put(39, 7, neg=True)
    lam = 0x2545F4914F6CDD1D
    lams = [Fp.broadcast_const(pow(lam, e, Fp.p), (1,), device=P.x.device)
            for e in (2, 3, 1)]
    jac = [8, 9, 10, 11] + ([n + 8, n + 9, n + 10, n + 11] if g2 else [])
    for a, l in zip(coords, lams):                  # (l^2 x, l^3 y, l z)
        a[:, jac] = Fp.mont_mul(a[:, jac], l).to(a.dtype)
    one = Fp.broadcast_const(1, (1,), device=P.x.device)[:, 0]
    for lane in (2, 3):
        coords[0][:, lane] = 0
        coords[1][:, lane] = one
        coords[2][:, lane] = 0
        if g2:
            for a in coords:
                a[:, n + lane] = 0
    return JacPoint(*(a.contiguous() for a in coords)), bits.to(P.x.device)


def check_ladder(g1a, g2h, imad_rate, N=4096, n_bits=32):
    """Phase 3, K3: each layout vs plain at check sizes; the ladder branch's
    shape (128 lanes x 254 bits, reduced) in the layout the wrapper picks
    there, vs plain; 254 bits vs the host's scalar products; and both
    layouts timed over lane counts (the crossover behind
    msm_kernels.SPLIT_MAX_LANES). Returns (max_abs_err, {variant: plain
    ms})."""
    import random

    import torch
    from zksc_tpu_torch.curve import bn254_host as host
    from zksc_tpu_torch.fields.limb import Fp
    from zksc_tpu_torch.ops import ec, msm_kernels
    err, plain_ms = 0, {}
    for g2 in (False, True):
        fops = ec.G2_OPS if g2 else ec.G1_OPS
        tag = "G2" if g2 else "G1"
        P = g2_lanes(g2h, 0, N) if g2 else g1_lanes(g1a, 0, N)
        P, bits = ladder_inputs(fops, P, n_bits, seed=11 + g2)
        shared = bits[:, 7].contiguous()
        t = time.time()
        per_lane = msm_kernels.ladder_plain(fops, P, bits, n_bits)
        torch.cuda.synchronize()
        plain_ms[f"{tag} unreduced"] = (time.time() - t) * 1e3
        cases = [("unreduced", bits, None, per_lane)]
        for seg in (64, N):
            t = time.time()
            want = msm_kernels._grouped_reduce(fops, per_lane, seg)
            torch.cuda.synchronize()
            plain_ms[f"{tag} reduced seg={seg}"] = \
                plain_ms[f"{tag} unreduced"] + (time.time() - t) * 1e3
            cases.append((f"reduced seg={seg}", bits, seg, want))
        t = time.time()
        want = msm_kernels.ladder_plain(fops, P, shared, n_bits)
        torch.cuda.synchronize()
        plain_ms[f"{tag} unreduced shared bits"] = (time.time() - t) * 1e3
        cases.append(("unreduced shared bits", shared, None, want))
        for layout, lname in k3_layouts().items():
            for label, b, seg, want in cases:
                run = lambda: msm_kernels._ladder(fops, P, b, n_bits, seg, layout)
                got = run()
                torch.cuda.synchronize()
                e = max_abs_diff(list(got), list(want))
                ms = cuda_ms(run, 5)
                bound, by, ops, _ = k3_bound_ms(fops, P, b, n_bits, seg, imad_rate)
                chain, _ = k3_chain_ms(fops, P, b, n_bits, seg, layout, imad_rate)
                log(f"K3 ladder {tag} {lname} {label} N={N} bits={n_bits}: "
                    f"kernel {ms:.4f} ms, plain "
                    f"{plain_ms.get(f'{tag} {label}', 0):.2f} ms, bound "
                    f"{bound:.4f} ms ({by}, {ops} point ops), chain floor "
                    f"{chain:.4f} ms, max_abs_err={e}")
                if e:
                    raise AssertionError(f"K3 {tag} {lname} {label}: kernel != plain")
                err = max(err, e)

    # the ladder branch's shape: one 128-lane MSM of 254-bit scalars
    for g2 in (False, True):
        fops = ec.G2_OPS if g2 else ec.G1_OPS
        tag = "G2" if g2 else "G1"
        P = g2_lanes(g2h, 0, 128) if g2 else g1_lanes(g1a, 0, 128)
        P, bits = ladder_inputs(fops, P, 254, seed=13 + g2)
        layout = msm_kernels._layout(128)
        t = time.time()
        want = msm_kernels.ladder_plain(fops, P, bits, 254, 128)
        torch.cuda.synchronize()
        plain_ms[f"{tag} reduced 128x254"] = (time.time() - t) * 1e3
        bound, by, ops, _ = k3_bound_ms(fops, P, bits, 254, 128, imad_rate)
        for lay, lname in k3_layouts().items():
            run = lambda: msm_kernels._ladder(fops, P, bits, 254, 128, lay)
            e = max_abs_diff(list(run()), list(want))
            ms = cuda_ms(run, 5)
            chain, rounds = k3_chain_ms(fops, P, bits, 254, 128, lay,
                                        imad_rate)
            log(f"K3 ladder {tag} {lname}{' (chosen)' if lay == layout else ''}"
                f" reduced N=128 bits=254: kernel {ms:.4f} ms, plain "
                f"{plain_ms[f'{tag} reduced 128x254']:.2f} ms, bound "
                f"{bound:.4f} ms ({by}, {ops} point ops), chain floor "
                f"{chain:.4f} ms ({rounds} product rounds), max_abs_err={e}")
            if e:
                raise AssertionError(f"K3 {tag} {lname} 128 x 254: kernel != plain")

    # 254-bit ladders on 8 lanes against the host's scalar products
    rnd = random.Random(17)
    scal = [rnd.randrange(1, host.R) for _ in range(8)]
    from zksc_tpu_torch.fields.limb import Fr
    bits = ec.scalars_to_bits(Fr, Fr.to_device(scal, mont=False,
                                                device=g1a.x.device), 254)
    for g2 in (False, True):
        fops = ec.G2_OPS if g2 else ec.G1_OPS
        P = g2_lanes(g2h, 0, 8) if g2 else g1_lanes(g1a, 0, 8)
        conv = ec.g2_jac_to_host_affine if g2 else ec.g1_jac_to_host_affine
        mul, add = (host.g2_mul, host.g2_add) if g2 else (host.g1_mul, host.g1_add)
        pts = conv(Fp, P, host.P)
        want = [mul(p, s) for p, s in zip(pts, scal)]
        got = conv(Fp, msm_kernels.ladder(fops, P, bits, 254), host.P)
        total = None
        for w in want:
            total = add(total, w)
        got_sum = conv(Fp, msm_kernels.ladder(fops, P, bits, 254, seg=8),
                       host.P)
        if got != want or got_sum != [total]:
            raise AssertionError(f"K3 {'G2' if g2 else 'G1'} 254-bit ladder "
                                 "!= bn254_host")
        log(f"K3 ladder {'G2' if g2 else 'G1'} 254 bits x 8 lanes == "
            "bn254_host (each lane and the sum)")
    sweep_ladder_layouts(g1a, g2h, imad_rate)
    return err, plain_ms


def sweep_ladder_layouts(g1a, g2h, imad_rate,
                         sizes=((32, (1024, 4096, 8192, 16384, 32768, 65536)),
                                (254, (8192, 16384)))):
    """Phase 3: every K3 layout's card time (CUDA events) over lane counts,
    per-lane and shared bits, G1 and G2, unreduced, at 32 bits and, near
    the crossover, at the 254 bits of every real K3 call: the crossover
    behind msm_kernels.SPLIT_MAX_LANES, which the wrapper's choice is
    logged beside. Then the ceremony's shape (262,144 G1 lanes, one
    254-bit scalar) with a fixed scalar: a contribution draws its scalar
    afresh, so phase 5's time of it moves with that scalar's bits between
    runs."""
    import random

    import torch
    from zksc_tpu_torch.ops import ec, msm_kernels
    layouts = k3_layouts()
    gen = torch.Generator().manual_seed(29)
    for n_bits, lane_counts in sizes:
        for g2 in (False, True):
            fops = ec.G2_OPS if g2 else ec.G1_OPS
            for n in lane_counts:
                P = g2_lanes(g2h, 0, n) if g2 else g1_lanes(g1a, 0, n)
                bits = torch.randint(0, 2, (n_bits, n), generator=gen,
                                     dtype=torch.int32).to(P.x.device)
                for form, b in (("per-lane", bits),
                                ("shared", bits[:, 0].contiguous())):
                    times = {name: cuda_ms(lambda: msm_kernels._ladder(
                        fops, P, b, n_bits, None, lay), 3)
                        for lay, name in layouts.items()}
                    pick = layouts[msm_kernels._layout(n)]
                    log(f"K3 layout sweep {'G2' if g2 else 'G1'} N={n} "
                        f"bits={n_bits} {form}: " + ", ".join(
                            f"{k} {v:.4f} ms" for k, v in times.items())
                        + f"; wrapper picks {pick}")
    n = 1 << 18
    P = g1_lanes(g1a, 0, n)
    scalar = random.Random(31).randrange(1, 1 << 254)
    b = torch.tensor([(scalar >> i) & 1 for i in range(254)], dtype=torch.int32,
                     device=P.x.device)
    lay = msm_kernels._layout(n)
    ms = cuda_ms(lambda: msm_kernels._ladder(ec.G1_OPS, P, b, 254, None, lay), 3)
    bound, by, ops, affine = k3_bound_ms(ec.G1_OPS, P, b, 254, None, imad_rate)
    log(f"K3 ceremony shape G1 N={n} bits=254, fixed scalar ({int(b.sum())} set "
        f"bits), {layouts[lay]}: kernel {ms:.4f} ms, bound {bound:.4f} ms "
        f"({by}, {ops} point ops, {affine} with affine Q), "
        f"{100 * bound / ms:.1f}% of the time")


def check_wide_windows(g1a, g2h, n=4096, n_top=16384):
    """Phase 3, K1 and K2 at the digit pattern of 254-bit wire scalars (the
    TOPRF statements' A, B1, B2, C MSMs): every K1 / K2 call of a bucket
    MSM with 13-bit windows (20 windows, the top one of 254 - 19 * 13 = 7
    bits) over n lanes, and of the top window alone over n_top lanes
    (digits below 2^7: at least 8,064 of the 8,192 buckets empty), replayed
    through the kernel and its plain version, equal limb for limb."""
    import random

    import torch
    from zksc_tpu_torch.curve import bn254_host as host
    from zksc_tpu_torch.fields.limb import Fr
    from zksc_tpu_torch.ops import ec, msm
    c, W = 13, 20
    rnd = random.Random(29)
    err = 0
    for g2 in (False, True):
        fops = ec.G2_OPS if g2 else ec.G1_OPS
        tag = "G2" if g2 else "G1"
        for label, lanes in (("20 windows", n), ("top window alone", n_top)):
            P = g2_lanes(g2h, 0, lanes) if g2 else g1_lanes(g1a, 0, lanes)
            vals = [rnd.randrange(host.R) for _ in range(lanes)]
            sp = Fr.to_device(vals, mont=False, device=P.x.device)
            rec = Recorder()
            with rec:
                rec.window = True
                if label == "20 windows":
                    msm.msm_pippenger_device(fops, P, sp, 254, c=c)
                else:
                    # the top window's digits as the only window of
                    # scalars shifted down by 19 windows
                    top = [v >> ((W - 1) * c) for v in vals]
                    if max(top) >= 1 << (254 - (W - 1) * c):
                        raise AssertionError("top window wider than 7 bits")
                    msm._window_sums(fops, P, Fr.to_device(
                        top, mont=False, device=P.x.device)[:, None, :], c, 1)
            t = time.time()
            n_calls = {"chunk_scan": 0, "jac_add_n": 0}
            for (name, _, _), f, args in rec.log:
                kern, plain = kernel_fns(name)
                e = max_abs_diff(flat_result(name, kern(f, *args)),
                                 flat_result(name, plain(f, *args)))
                if e:
                    raise AssertionError(f"{name} {tag} at 13-bit windows "
                                         f"({label}): kernel != plain")
                n_calls[name] += 1
                err = max(err, e)
            torch.cuda.synchronize()
            log(f"K1/K2 {tag} 254-bit scalars, 13-bit windows, {label}, "
                f"n={lanes}: {n_calls} calls, each kernel == plain "
                f"({time.time() - t:.2f} s)")
            if not all(n_calls.values()):
                raise AssertionError(f"{tag} {label}: a kernel was not called")
    return err


def check_stable_sort(n=131072, c=13, W=20):
    """Phase 3: the MSM's keyed sort at the TOPRF shape (W windows of n
    lanes, chacha20-toprf's 13-bit windows): torch.sort(stable=True) on the
    card must give THE stable permutation (keys ascending, ties in index
    order), the one lax.sort gives. Scalars as a TOPRF witness holds them:
    mostly bits, one in ten full width."""
    import random

    import torch
    from zksc_tpu_torch.curve import bn254_host as host
    from zksc_tpu_torch.fields.limb import Fr
    from zksc_tpu_torch.ops import msm
    rnd = random.Random(31)
    vals = [rnd.randrange(host.R) if rnd.random() < 0.1 else rnd.randrange(2)
            for _ in range(n)]
    sp = Fr.to_device(vals, mont=False, device="cuda")
    digits = msm.scalars_to_digits(sp, c, W)[None]            # [1, W, n]
    f = ((1 << c) - 1) - digits.to(torch.int64)
    seg = torch.arange(W, dtype=torch.int64, device="cuda").reshape(1, W, 1)
    key = (seg * (1 << c) + f).reshape(-1)
    _, sidx = torch.sort(key, stable=True)
    k = key[sidx]
    ok = bool(((k[1:] > k[:-1]) | ((k[1:] == k[:-1]) & (sidx[1:] > sidx[:-1])))
              .all().item())
    log(f"torch.sort(stable=True) over {W} x {n} MSM keys: the stable "
        f"permutation: {ok}")
    if not ok:
        raise AssertionError("torch.sort(stable=True) broke a tie's order")


class Recorder:
    """Wraps the module attributes that ops/msm.py and ops/ec.py call (the
    wrapped functions run unchanged) and keeps, per kernel variant, the
    first of the largest inputs a path gave it (`calls`); while `window` is
    set it also keeps every call in order (`log`), holding its inputs. On
    the ceremony's path the K3 input kept is h_query: it and c_query have
    the same lane count, and _apply_delta scales h_query first. Likewise
    for the Groth16 H kernels (`h_calls`, `h_log`): the h_kernels functions
    groth16/prove.py and ops/ntt_sharded.py call, NTTContext._transform
    and ShardedNTT._local_block (a mesh block's K4 call), on CUDA
    tensors. Likewise for the bucket MSM's glue (`glue_calls`,
    `glue_log`): the msm_glue wrappers ops/msm.py calls, K6a-d."""

    def __init__(self):
        from zksc_tpu_torch.ops import ec_kernels, h_kernels, msm_glue, msm_kernels
        from zksc_tpu_torch.ops.ntt import NTTContext
        from zksc_tpu_torch.ops.ntt_sharded import ShardedNTT
        self.mods = {"chunk_scan": ec_kernels, "jac_add_n": ec_kernels,
                     "ladder": msm_kernels}
        self.orig = {k: getattr(m, k) for k, m in self.mods.items()}
        self.h_mods = {"to_mont": h_kernels, "quotient": h_kernels,
                       "pack_z": h_kernels, "cross_stage": h_kernels,
                       "sparse_matvec": h_kernels, "_transform": NTTContext,
                       "_local_block": ShardedNTT}
        self.h_orig = {k: getattr(m, k) for k, m in self.h_mods.items()}
        self.glue_mod = msm_glue
        self.glue_orig = {k: getattr(msm_glue, k) for k in GLUE_WRAPPERS}
        self.glue_calls = {}
        self.glue_log = []
        self.calls = {}
        self.log = []
        self.h_calls = {}
        self.h_log = []
        self.window = False

    def _h_wrap(self, attr):
        fn = self.h_orig[attr]

        def call(*args):
            key, x = h_variant(attr, args)
            if x.device.type == "cuda":
                prev = self.h_calls.get(key)
                if prev is None or x.numel() > prev[1]:
                    self.h_calls[key] = (args, x.numel())
                if self.window:
                    self.h_log.append((key, args))
            return fn(*args)
        return call

    def _glue_wrap(self, attr):
        fn = self.glue_orig[attr]
        name = GLUE_WRAPPERS[attr]

        def call(*args):
            key, size, dev = glue_variant(name, args)
            if dev.type == "cuda":
                prev = self.glue_calls.get(key)
                if prev is None or size > prev[1]:
                    self.glue_calls[key] = (args, size)
                if self.window:
                    self.glue_log.append((key, args))
            return fn(*args)
        return call

    def __enter__(self):
        from zksc_tpu_torch.ops import ec, ec_kernels

        def wrap(name, flag_of):
            fn = self.orig[name]

            def call(fops, *args, **kw):
                args = args + tuple(kw.values())    # trailing parameters
                key = (name, isinstance(fops, ec.Fp2Ops), flag_of(args))
                width = ec_kernels._lanes(fops, args[0].x)
                prev = self.calls.get(key)
                if prev is None or width > prev[2]:
                    self.calls[key] = (fops, args, width)
                if self.window:
                    self.log.append((key, fops, args))
                return fn(fops, *args)
            return call

        def ladder_mode(args):
            bits, seg = args[1], (args[3] if len(args) > 3 else None)
            return "reduced" if seg is not None else (
                "unreduced shared bits" if bits.dim() == 1 else "unreduced")

        flags = {"chunk_scan": lambda a: a[2],
                 "jac_add_n": lambda a: a[2] if len(a) > 2 else True,
                 "ladder": ladder_mode}
        for name, mod in self.mods.items():
            setattr(mod, name, wrap(name, flags[name]))
        for attr, mod in self.h_mods.items():
            setattr(mod, attr, self._h_wrap(attr))
        for attr in GLUE_WRAPPERS:
            setattr(self.glue_mod, attr, self._glue_wrap(attr))
        return self

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            setattr(mod, name, self.orig[name])
        for attr, mod in self.h_mods.items():
            setattr(mod, attr, self.h_orig[attr])
        for attr, fn in self.glue_orig.items():
            setattr(self.glue_mod, attr, fn)


def kernel_fns(name):
    """(kernel wrapper, plain version) of a recorded kernel name."""
    from zksc_tpu_torch.ops import ec_kernels, msm_kernels
    return {"chunk_scan": (ec_kernels.chunk_scan, ec_kernels.chunk_scan_plain),
            "jac_add_n": (ec_kernels.jac_add_n, ec_kernels.jac_add_n_plain),
            "ladder": (msm_kernels.ladder, msm_kernels.ladder_plain)}[name]


def bound_of(name, fops, args, imad_rate):
    """(bound ms, bound_by, point ops needed, affine-Q adds) of one call."""
    if name == "chunk_scan":
        return k1_bound_ms(fops, args[0], args[1], imad_rate)
    if name == "jac_add_n":
        return k2_bound_ms(fops, args[0], args[1], imad_rate)
    points, bits, n_bits = args[:3]
    seg = args[3] if len(args) > 3 else None
    return k3_bound_ms(fops, points, bits, n_bits, seg, imad_rate)


def flat_result(name, r):
    return list(r[0]) + list(r[1]) if name == "chunk_scan" else list(r)


def time_kernels(calls, imad_rate, path: str):
    """Phase 5: replay each variant's largest input of one path through the
    kernel and its plain version (equal limb for limb)."""
    import torch
    from zksc_tpu_torch.ops import ec_kernels, msm_kernels
    from zksc_tpu_torch.ops.ec import JacPoint
    rows = []
    for key in sorted(calls):
        name, g2, flag = key
        fops, args, width = calls[key]
        kern, plain = kernel_fns(name)
        run = lambda: kern(fops, *args)
        tag = "G2" if g2 else "G1"
        bound, by, ops, affine = bound_of(name, fops, args, imad_rate)
        extra = {}
        if name == "ladder":
            P, bits, n_bits = args[:3]
            seg = args[3] if len(args) > 3 else None
            n = fops.lane_width(P.x)
            shape = f"N={n} bits={n_bits}" + ("" if seg is None else f" seg={seg}")
            label = f"{tag} {flag}"
            layout = msm_kernels._layout(n)
            chain, rounds = k3_chain_ms(fops, P, bits, n_bits, seg, layout,
                                        imad_rate)
            extra = {"layout": k3_layouts()[layout]}
        elif name == "chunk_scan":
            shape = f"S={args[1]} C={ec_kernels._lanes(fops, args[0].x) // args[1]}"
            label = f"{tag} inclusive={flag}"
        else:
            shape = f"N={ec_kernels._lanes(fops, args[0].x)}"
            label = f"{tag} complete={flag}"
        if name == "ladder" and seg is None and n > 128:
            # the plain ladder over every lane would take minutes: hold
            # the kernel to it on a sample that reaches every block of
            # 128 lanes (the first and last blocks whole, and one lane
            # at a different offset in each block)
            blk = torch.arange(n // 128, device=P.x.device)
            idx = torch.unique(torch.cat([
                torch.arange(128, device=P.x.device), blk * 128 + blk % 128,
                torch.arange(n - 128, n, device=P.x.device)]))
            pick = lambda A: JacPoint(*(fops.lane_map(
                lambda a: a[:, idx].contiguous(), c) for c in A))
            hb = bits if bits.dim() == 1 else bits[:, idx].contiguous()
            got = pick(run())
            want = msm_kernels.ladder_plain(fops, pick(P), hb, n_bits)
            err = max_abs_diff(list(got), list(want))
            if err:
                raise AssertionError(f"{name} {label}: kernel != plain")
            ms = cuda_ms(run, reps=3)
            plain_ms = None
        else:
            ms, plain_ms, err = compare(f"{name} {label} {shape}", run,
                                        lambda: plain(fops, *args),
                                        lambda r: flat_result(name, r))
        paced = cuda_ms(run, reps=3, paced=True)
        log(f"[{path}] {name} {label} {shape}: kernel {ms:.4f} ms ({paced:.4f} "
            f"ms paced by the host), plain "
            f"{'not run at this size' if plain_ms is None else f'{plain_ms:.2f} ms'}"
            f", bound {bound:.4f} ms ({by}, {ops} point ops, {affine} with "
            f"affine Q)" + (f", layout {extra['layout']}, chain floor "
                            f"{chain:.4f} ms ({rounds} product rounds)"
                            if extra else "")
            + f", max_abs_err={err}")
        rows.append({"name": name, "path": path, "variant": label,
                     "shape": shape, "ms": ms, "paced_ms": paced,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "ops_needed": ops,
                     "affine_q_adds": affine, "max_abs_err": err, **extra})
    return rows


def proof_totals(log_calls, imad_rate, path: str, counts, reset_counts):
    """Phase 5: every kernel call of one warm proof, in order, replayed
    through the kernel (CUDA events, 2 launches after a warm-up); per
    kernel the launches, the summed ms, the summed bound and the adds whose
    Q is affine. The inputs of the whole proof are held meanwhile."""
    import torch
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tot = {}
    for (name, g2, flag), fops, args in log_calls:
        kern, _ = kernel_fns(name)
        reset_counts()
        kern(fops, *args)
        n_launch = counts()[name]
        ms = cuda_ms(lambda: kern(fops, *args), reps=2)
        paced = cuda_ms(lambda: kern(fops, *args), reps=2, paced=True)
        bound, _, ops, affine = bound_of(name, fops, args, imad_rate)
        t = tot.setdefault(name, {"launches": 0, "ms": 0.0, "paced_ms": 0.0,
                                  "bound_ms": 0.0, "ops_needed": 0,
                                  "affine_q_adds": 0})
        t["launches"] += n_launch
        t["ms"] += ms
        t["paced_ms"] += paced
        t["bound_ms"] += bound
        t["ops_needed"] += ops
        t["affine_q_adds"] += affine
    peak = torch.cuda.max_memory_allocated()
    for name, t in sorted(tot.items()):
        log(f"[{path} warm proof] {name}: {t['launches']} launches, kernel "
            f"{t['ms']:.4f} ms in all ({t['paced_ms']:.4f} ms paced by the "
            f"host), bound {t['bound_ms']:.4f} ms "
            f"({100 * t['bound_ms'] / max(t['ms'], 1e-9):.1f}% of the time), "
            f"{t['ops_needed']} point ops needed, {t['affine_q_adds']} adds "
            f"with affine Q")
    log(f"[{path} warm proof] inputs held: {held / 2**30:.3f} GiB allocated, "
        f"peak {peak / 2**30:.3f} GiB during the replay")
    return tot


# ------------------------------------------------------------- K6

GLUE_NAMES = ("msm_keys", "sorted_gather", "scan_top", "bucket_boundaries")
GLUE_SRC = "zksc_tpu_torch/csrc/msm_glue.cu"
# the reference's XLA-fused code each K6 kernel replaces
GLUE_REPLACES = {
    "msm_keys": "zksc_tpu/ops/msm.py:67",          # + :214-221, segment_sum
    "sorted_gather": "zksc_tpu/ops/msm.py:225",
    "scan_top": "zksc_tpu/ops/msm.py:164",
    "bucket_boundaries": "zksc_tpu/ops/msm.py:241",
}
# msm_glue's wrapper of each K6 kernel
GLUE_WRAPPERS = {"keys": "msm_keys", "sorted_gather": "sorted_gather",
                 "scan_top": "scan_top",
                 "bucket_boundaries": "bucket_boundaries"}
# the five MSMs of a warm chacha20 proof: their launch calls, at most, and
# the parent commit's (14eab77: K1 / K2 and eager glue), a recorded
# constant: measured by tools/msm_stage_torch.py on an H100 80GB HBM3 at
# 700 W before K6 (PERF.md), not in the run that prints it
MSM_STAGE_MAX_LAUNCHES = 300
MSM_STAGE_PARENT_LAUNCHES = 1962


def glue_fns(name):
    """(kernel launch, plain version) of a K6 kernel."""
    from zksc_tpu_torch.ops import msm_glue as g
    return {"msm_keys": (g._launch_keys, g.keys_plain),
            "sorted_gather": (g._launch_sorted_gather, g.sorted_gather_plain),
            "scan_top": (g._launch_scan_top, g.scan_top_plain),
            "bucket_boundaries": (g._launch_bucket_boundaries,
                                  g.bucket_boundaries_plain)}[name]


def _glue_g2(args) -> bool:
    from zksc_tpu_torch.ops import ec
    return isinstance(args[0], ec.Fp2Ops)


def glue_variant(name, args):
    """((name, variant), size, device) of one K6 call."""
    from zksc_tpu_torch.ops import ec_kernels
    if name == "msm_keys":
        from zksc_tpu_torch.ops import msm_glue
        sp, c, W = args
        dt = msm_glue.key_dtype(sp.shape[1] * W, c)
        # the keys it writes: the H MSM's (W = 20) outweighs the 40-bit ones
        return ((name, f"{str(dt)[6:]} keys"), sp.shape[1] * W * sp.shape[2],
                sp.device)
    tag = "G2" if _glue_g2(args) else "G1"
    if name == "scan_top":
        fops, P, inclusive = args
        return ((name, f"{tag} inclusive={inclusive}"),
                ec_kernels._lanes(fops, P.x), P.x.device)
    t = args[2]                                  # sidx, or cum
    return (name, tag), t.numel(), t.device


def glue_shape(name, args) -> str:
    from zksc_tpu_torch.ops import ec_kernels
    if name == "msm_keys":
        sp, c, W = args
        return f"c={c} W={W} k={sp.shape[1]} n={sp.shape[2]}"
    if name == "sorted_gather":
        return f"N={args[2].shape[0]} C0={args[4]}"
    if name == "scan_top":
        return f"T={ec_kernels._lanes(args[0], args[1].x)}"
    _, levels, cum, c, n = args
    return f"lanes={cum.numel()} levels={len(levels)} n={n}"


def glue_bound_ms(name, args, imad_rate):
    """(bound ms, by, point adds needed) of one K6 call: the bytes it must
    move (each input it needs read once, each output written once) and
    the point adds these inputs need (16 products a G1 add, 48 a G2 add:
    the sums are Jacobian)."""
    import torch
    from zksc_tpu_torch.ops import ec_kernels, msm_glue
    if name == "msm_keys":
        sp, c, W = args
        L, k, n = sp.shape
        segs = k * W
        kb = 4 if msm_glue.key_dtype(segs, c) == torch.int32 else 8
        rows = min(L, -(-W * c // 16))         # the limb rows the windows read
        nbytes = 4 * rows * k * n + kb * segs * n + 4 * (segs << c)
        return (*_bound(0, nbytes, imad_rate), 0)
    fops = args[0]
    g2 = _glue_g2(args)
    pt = 3 * (2 if g2 else 1) * 16 * 4
    if name == "sorted_gather":
        _, _, sidx, n, _ = args
        N = sidx.shape[0]
        return (*_bound(0, 8 * N + pt * (n + N), imad_rate), 0)
    if name == "scan_top":
        P = ec_kernels.folded(fops, args[1])
        T = fops.lane_width(P.x)
        adds = max(int(nonid(fops, P).sum().item()) - 1, 0)
        return (*_bound(add_imad(g2, adds, 0), 2 * pt * T, imad_rate), adds)
    _, levels, cum, c, n = args
    segs, two_c = cum.shape
    q = torch.arange(two_c, device=cum.device)
    live = int(((cum > 0) & (q[None, :] != two_c - 1)).sum().item())
    L = len(levels)
    # a live bucket lane: L - 1 level offsets and the segment prefix; a
    # segment prefix: L - 1 level offsets
    adds = live * L + segs * (L - 1)
    nbytes = 4 * cum.numel() + pt * (L * (live + segs) + cum.numel() + segs)
    return (*_bound(add_imad(g2, adds, 0), nbytes, imad_rate), adds)


def time_glue_kernels(calls, imad_rate, path: str):
    """Phase 3 and 5: each K6 variant's largest call of one path replayed
    through the kernel and its plain version (equal limb for limb), timed
    (card-only and host-paced CUDA events) beside its bound; beside K6a,
    torch.sort(stable=True) of its keys, the sort that follows it."""
    import torch
    rows = []
    for key in sorted(calls, key=str):
        args, _ = calls[key]
        name = key[0]
        kern, plain = glue_fns(name)
        run = lambda: kern(*args)
        shape = glue_shape(name, args)
        ms, plain_ms, err = compare(f"{name} {key[1]} {shape}", run,
                                    lambda: plain(*args), list)
        paced = cuda_ms(run, reps=3, paced=True)
        bound, by, adds = glue_bound_ms(name, args, imad_rate)
        row = {"name": name, "path": path, "variant": key[1], "shape": shape,
               "ms": ms, "paced_ms": paced, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "ops_needed": adds,
               "max_abs_err": err}
        extra = ""
        if name == "msm_keys":
            keys = run()[0]
            row["sort_ms"] = cuda_ms(lambda: torch.sort(keys, stable=True),
                                     reps=3)
            extra = f", torch.sort of its keys {row['sort_ms']:.4f} ms"
        log(f"[{path}] {name} {key[1]} {shape}: kernel {ms:.4f} ms "
            f"({paced:.4f} ms paced by the host), plain {plain_ms:.2f} ms, "
            f"bound {bound:.4f} ms ({by}, {adds} point adds){extra}, "
            f"max_abs_err={err}")
        rows.append(row)
    return rows


def glue_proof_totals(log_calls, imad_rate, path: str, counts, reset_counts):
    """Phase 5: every K6 call of one warm proof (or batch), in order,
    replayed through the kernel: per kernel the launches, the summed ms
    (card-only and host-paced) and the summed bound."""
    tot = {}
    for key, args in log_calls:
        name = key[0]
        kern, _ = glue_fns(name)
        run = lambda: kern(*args)
        reset_counts()
        run()
        n_launch = counts()[name]
        ms = cuda_ms(run, reps=2)
        paced = cuda_ms(run, reps=2, paced=True)
        bound, _, adds = glue_bound_ms(name, args, imad_rate)
        t = tot.setdefault(name, {"launches": 0, "ms": 0.0, "paced_ms": 0.0,
                                  "bound_ms": 0.0, "ops_needed": 0})
        t["launches"] += n_launch
        t["ms"] += ms
        t["paced_ms"] += paced
        t["bound_ms"] += bound
        t["ops_needed"] += adds
    for name, t in sorted(tot.items()):
        log(f"[{path} warm proof] {name}: {t['launches']} launches, kernel "
            f"{t['ms']:.4f} ms in all ({t['paced_ms']:.4f} ms paced by the "
            f"host), bound {t['bound_ms']:.4f} ms "
            f"({100 * t['bound_ms'] / max(t['ms'], 1e-9):.1f}% of the time), "
            f"{t['ops_needed']} point adds")
    return tot


def glue_kernel_entries(rows, per_proof, launches, batch_launches,
                        mesh_launches, err):
    """The K6a-d entries of the kernels line: each kernel's largest call of
    phase 4's warm chacha20 proof (K6a: torch.sort's time beside it), its
    launches there, in phase 13's D = 4 mesh proof and phase 14's
    batches, and the per-proof totals of every recorded path."""
    entries = []
    for name in GLUE_NAMES:
        mine = [r for r in rows if r["name"] == name]
        main = max((r for r in mine if r["path"] == "chacha20"),
                   key=lambda r: r["bound_ms"])
        entry = {
            "name": name, "route": "cuda", "source": GLUE_SRC,
            "replaces": GLUE_REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "path": "chacha20",
            "shape": f"{main['variant']} {main['shape']}",
            "launches_batch4": {a: n[name] for a, n in batch_launches.items()},
            "launches_mesh4": mesh_launches[name],
            "per_proof": {p: t[name] for p, t in per_proof.items()
                          if name in t},
            "variants": mine}
        if "sort_ms" in main:
            entry["sort_ms"] = main["sort_ms"]
        entries.append(entry)
    return entries


def check_glue_kernels(g1a, g2h, imad_rate, n=1 << 16):
    """Phase 3: K6a-d against their plain versions at the shapes of the
    chacha20 proof's H MSM (G1, 254-bit scalars, c = 13, W = 20: N =
    1,310,720 sorted lanes, a top of 5,120 lanes, 163,840 bucket lanes)
    and B2 MSM (G2, 40-bit witness-like scalars, c = 10, W = 4: N =
    262,144, a top of 1,024 lanes, 4,096 bucket lanes), over n = 65,536
    points of the committed key taken cyclically (duplicated points) with
    64 identity lanes: one _window_sums each on the card, its K6 calls
    recorded and replayed through the kernel and its plain version (equal
    limb for limb), timed beside their bounds; the window sums equal,
    limb for limb, those of the plain glue (every K6 call on its plain
    version, K1 and K2 on their kernels)."""
    import random

    from zksc_tpu_torch.curve import bn254_host as host
    from zksc_tpu_torch.fields.limb import Fr
    from zksc_tpu_torch.ops import ec, msm, msm_glue
    from zksc_tpu_torch.ops.ec import JacPoint
    rnd = random.Random(37)
    rows = []
    for label, g2, n_bits, c in (("chacha20 H", False, 254, 13),
                                 ("chacha20 B2", True, 40, 10)):
        t = time.time()
        fops = ec.G2_OPS if g2 else ec.G1_OPS
        P = g2_lanes(g2h, 0, n) if g2 else g1_lanes(g1a, 0, n)
        z = P.z.clone()
        z[:, :64] = 0
        if g2:
            z[:, n:n + 64] = 0
        P = JacPoint(P.x, P.y, z)
        if g2:
            vals = [rnd.randrange(1 << n_bits) if rnd.random() < 0.1
                    else rnd.randrange(2) for _ in range(n)]
        else:
            vals = [rnd.randrange(host.R) for _ in range(n)]
        vals[:4] = [0, 1, 0, 1]
        sp = Fr.to_device(vals, mont=False, device=P.x.device)[:, None, :]
        W = -(-n_bits // c)
        rec = Recorder()
        with rec:
            sums = msm._window_sums(fops, P, sp, c, W)
        names = sorted({k[0] for k in rec.glue_calls})
        if names != sorted(GLUE_NAMES):
            raise AssertionError(f"{label}: K6 calls {names}")
        rows += time_glue_kernels(rec.glue_calls, imad_rate,
                                  f"phase 3 {label}")
        saved = {a: getattr(msm_glue, a) for a in GLUE_WRAPPERS}
        try:
            for a in GLUE_WRAPPERS:
                setattr(msm_glue, a, getattr(msm_glue, a + "_plain"))
            plain = msm._window_sums(fops, P, sp, c, W)
        finally:
            for a, f in saved.items():
                setattr(msm_glue, a, f)
        if max_abs_diff(list(sums), list(plain)):
            raise AssertionError(f"{label}: window sums != the plain glue's")
        log(f"phase 3 K6 at the {label} MSM shape (n={n}, c={c}, W={W}): "
            f"each kernel == plain, window sums == the plain glue's "
            f"({time.time() - t:.2f} s)")
    return max(r["max_abs_err"] for r in rows)


def msm_stage_check(api):
    """Phase 4: the five MSMs of a warm chacha20 proof replayed under
    torch.cuda.set_sync_debug_mode("error") (tools/msm_stage_torch.py):
    no synchronising call, and at most MSM_STAGE_MAX_LAUNCHES profiled
    launch calls, printed beside the parent commit's recorded count."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import msm_stage_torch
    t = time.time()
    res = msm_stage_torch.measure(api, error=True)
    log(f"phase 4 MSM stage (5 MSMs of a warm chacha20 proof, replayed): "
        f"{res['launch_calls']} kernel launch calls (parent 14eab77, a "
        f"recorded constant, not this run's: {MSM_STAGE_PARENT_LAUNCHES}; "
        f"cap {MSM_STAGE_MAX_LAUNCHES}), "
        f"{res['syncs']} synchronising calls under sync debug mode error, "
        f"{res['stage_s']:.4f} s host clock, {res['card_ms_profiled']:.3f} "
        f"card ms profiled; shapes {res['shapes']}; other warnings "
        f"{res['other_warnings']} ({time.time() - t:.2f} s)")
    if res["syncs"]:
        raise AssertionError("phase 4: the MSM stage synchronised")
    if res["launch_calls"] > MSM_STAGE_MAX_LAUNCHES:
        raise AssertionError(f"phase 4: {res['launch_calls']} launch calls "
                             f"in the MSM stage, over {MSM_STAGE_MAX_LAUNCHES}")
    return res


AES_SEED = 20240          # keygen --seed of phase 6 (not a secret key)


def drive_aes(api, reset_counts, counts, rec) -> dict:
    """Phase 6. Returns the kernel launch counts of the path; `rec` logs
    every kernel call of the warm proof."""
    import random

    import torch
    from zksc_tpu_torch import keygen
    from zksc_tpu_torch.groth16 import artifacts as art, ceremony
    from zksc_tpu_torch.operators import CircuitSpec
    for alg in ("aes-128-ctr", "aes-256-ctr"):
        t = time.time()
        cs = CircuitSpec(alg).cs
        with open(os.path.join(HERE, "artifacts", alg, "manifest.json")) as f:
            want = json.load(f)["digest"]
        log(f"phase 6 {alg} circuit: {cs.n_constraints} constraints, "
            f"{cs.n_wires} wires, digest {cs.digest()[:12]}.. "
            f"({time.time() - t:.2f} s)")
        if cs.digest() != want:
            raise AssertionError(f"{alg} digest {cs.digest()} != manifest {want}")
    alg = "aes-128-ctr"
    digest = CircuitSpec(alg).cs.digest()
    store = os.path.join(keygen.KEY_STORE, alg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    times = keygen.run(alg, seed=AES_SEED,
                       log=lambda m: log(f"phase 6 keygen {m}"))
    log("phase 6 keygen stages: " + " ".join(f"{k}={v:.2f}"
                                             for k, v in times.items())
        + f" (total {time.time() - t0:.2f} s)")
    t = time.time()
    pk, vk = art.load_keys(store, expected_digest=digest, device="cuda")
    torch.cuda.synchronize()
    log(f"phase 6 load_keys: {time.time() - t:.2f} s")
    t = time.time()
    pk1, vk1, con = ceremony.contribute(pk, vk, entropy=b"chip_smoke")
    torch.cuda.synchronize()
    log(f"phase 6 ceremony contribute (K3 over h_query and c_query, "
        f"{pk.h_query.x.shape[1]} and {pk.c_query.x.shape[1]} lanes): "
        f"{time.time() - t:.2f} s")
    t = time.time()
    checks = {
        "verify_chain": ceremony.verify_chain(pk.delta_g1, pk.delta_g2, [con]),
        "h_query scaled": ceremony.verify_query_scaling(
            pk.h_query, pk1.h_query, pk.delta_g2, pk1.delta_g2, 16),
        "c_query scaled": ceremony.verify_query_scaling(
            pk.c_query, pk1.c_query, pk.delta_g2, pk1.delta_g2, 16),
        "unscaled query rejected": not ceremony.verify_query_scaling(
            pk.h_query, pk.h_query, pk.delta_g2, pk1.delta_g2, 16),
    }
    log(f"phase 6 ceremony checks {checks} ({time.time() - t:.2f} s)")
    if not all(checks.values()):
        raise AssertionError(f"ceremony checks failed: {checks}")
    t = time.time()
    art.save_keys(store, pk1, vk1)
    log(f"phase 6 save contributed keys: {time.time() - t:.2f} s")
    del pk, vk, pk1, vk1

    rnd = random.Random(2025)
    key = bytes(rnd.randrange(256) for _ in range(16))
    iv = bytes(rnd.randrange(256) for _ in range(12))
    ct = bytes(rnd.randrange(256) for _ in range(80))
    blind = random.Random(9)
    rng = lambda: blind.randrange(1, 1 << 250)
    for i in (1, 2):
        t = time.time()
        rec.window = i == 2
        env = api.generate_proof(alg, key, ct, iv, device="cuda", rng=rng)
        rec.window = False
        torch.cuda.synchronize()
        op = api.get_operator(alg, "groth16", "cuda")
        stages = " ".join(f"{k}={v:.3f}" for k, v in op.timings.items())
        log(f"phase 6 aes-128-ctr proof {i} ({'keys load + context + ' if i == 1 else ''}"
            f"prove): {time.time() - t:.3f} s ({stages})")
    launches = counts()
    log(f"phase 6 launches over keygen, ceremony and both proofs: {launches}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for k in ("chunk_scan", "jac_add_n", "ladder") + H_NAMES + GLUE_NAMES:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the AES path")
    t = time.time()
    ok = api.verify_proof(env, ct, iv, device="cuda")
    log(f"phase 6 verify: {ok} ({time.time() - t:.2f} s)")
    if not ok:
        raise AssertionError("the aes-128-ctr proof did not verify")
    bad = ct[:5] + bytes([ct[5] ^ 0x10]) + ct[6:]
    if api.verify_proof(env, bad, iv, device="cuda"):
        raise AssertionError("a tampered aes-128-ctr ciphertext verified")
    log(f"phase 6 tampered ciphertext rejected; phase 6 total "
        f"{time.time() - t0:.2f} s")
    return launches


TOPRF_SEED = 20241        # keygen --seed of phase 8 (not a secret key)
TOPRF_ALGS = ("chacha20-toprf", "aes-128-ctr-toprf", "aes-256-ctr-toprf")


def toprf_round(api, plaintext: bytes, pos: int, length: int):
    """Phase 8's host TOPRF round through the port's OPRFOperator, on the
    wire format: threshold keys n=3, t=2; a request over the redacted span
    plaintext[pos:pos+length]; evaluations by shares 1 and 2; finalise,
    which must give the output of the master key. The circuit checks one
    share's response (THRESHOLD = 1, as the reference's toprf.go), so the
    proof's signals carry share 1's response and its own finalised output.
    Returns (signals, mask, signals carrying share 2's response)."""
    import random
    from base64 import b64decode

    from zksc_tpu_torch.oprf import oprf
    from zksc_tpu_torch.oprf.operator import make_oprf_operator
    from zksc_tpu_torch.oprf.operator import point_from_bytes
    rnd = random.Random(4242)
    op = make_oprf_operator(rng=lambda: rnd.randrange(2, oprf.L),
                            device="cuda")
    num = lambda b64: int.from_bytes(b64decode(b64), "big")
    pt = lambda b64: point_from_bytes(b64decode(b64))
    t = time.time()
    keys = op.generate_threshold_keys(3, 2)
    request = op.generate_oprf_request_data(plaintext[pos:pos + length],
                                            "reclaim")
    responses = []
    for share in keys["shares"][:2]:
        r = op.evaluate_oprf(share["privateKey"], request["maskedData"])
        responses.append(dict(r, index=share["index"],
                              publicKeyShare=share["publicKey"]))
    output = num(op.finalise_oprf(keys["publicKey"], request,
                                  responses)["output"])
    req = oprf.OPRFRequest(mask=num(request["mask"]),
                           masked_point=pt(request["maskedData"]),
                           secret_elements=[num(b) for b in
                                            request["secretElements"]])
    master = oprf.finalize(req, oprf.evaluate(num(keys["privateKey"]),
                                              req.masked_point))
    if output != master:
        raise AssertionError("threshold output != the master key's output")
    signals = []
    for r in responses:
        resp = oprf.OPRFResponse(
            evaluated=pt(r["evaluated"]),
            public_key=pt(r["publicKeyShare"]),
            dleq=oprf.DLEQProof(c=num(r["c"]), r=num(r["r"])))
        signals.append(api.TOPRFResponseSignals(
            index=r["index"], public_key=resp.public_key,
            evaluated=resp.evaluated, c=resp.dleq.c, r=resp.dleq.r))
    own = oprf.threshold_finalize(req, {1: oprf.OPRFResponse(
        signals[0].evaluated, signals[0].public_key,
        oprf.DLEQProof(signals[0].c, signals[0].r))})
    make = lambda resp: api.ZKTOPRFPublicSignals(
        locations=[(pos, length)], domain_separator=b"reclaim", output=own,
        responses=[resp])
    log(f"phase 8 TOPRF round (n=3, t=2, span [{pos}, {pos + length}) of "
        f"{len(plaintext)} bytes): threshold output == master key's, "
        f"{time.time() - t:.2f} s on the host")
    return make(signals[0]), req.mask, make(signals[1])


def drive_toprf(api, alg: str, reset_counts, counts, rec) -> dict:
    """Phase 8 for one -toprf statement: keygen on the card into the port's
    key store, a host TOPRF round, three proofs through api.generate_proof
    (cold; warm, with the launch counters reset just before it, its stage
    seconds and peak device memory; one more whose kernel calls `rec`
    logs for phase 5), verify and three tampered cases. Returns the warm
    proof's launch counts."""
    import random

    import torch
    from zksc_tpu_torch import keygen
    from zksc_tpu_torch.config import CONFIG
    from zksc_tpu_torch.operators import Groth16Operator
    base = alg[: -len("-toprf")]
    cfg = CONFIG[alg]
    t0 = time.time()
    times = keygen.run(alg, seed=TOPRF_SEED,
                       log=lambda m: log(f"phase 8 keygen {m}"))
    log("phase 8 keygen stages: " + " ".join(f"{k}={v:.2f}"
                                             for k, v in times.items())
        + f" (total {time.time() - t0:.2f} s)")
    # prove with the key made here, also where the checkout holds the JAX
    # package's committed key under artifacts/
    store = os.path.join(keygen.KEY_STORE, alg)
    op = Groth16Operator(alg, artifact_dir=store, allow_setup=False,
                         device="cuda")
    api._OPERATORS[(alg, "groth16", "cuda")] = op

    rnd = random.Random(2026)
    key = bytes(rnd.randrange(256) for _ in range(cfg.key_size_bytes))
    iv = bytes(rnd.randrange(256) for _ in range(cfg.iv_size_bytes))
    pt = bytes(rnd.randrange(256) for _ in range(cfg.chunk_size_bytes))
    ct = api._decrypt(base, key, iv, cfg.start_counter, pt)
    pos, length = (32, 24) if base == "chacha20" else (20, 24)
    signals, mask, other = toprf_round(api, pt, pos, length)
    blind = random.Random(11)
    rng = lambda: blind.randrange(1, 1 << 250)
    for i, label in ((1, "cold: keys load + context + prove"),
                     (2, "warm"), (3, "recorded for phase 5")):
        torch.cuda.synchronize()
        if i == 2:
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            reset_counts()
        t = time.time()
        if i == 3:
            with rec:
                rec.window = True
                env = api.generate_proof(base, key, ct, iv, toprf=signals,
                                         mask=mask, device="cuda", rng=rng)
                rec.window = False
        else:
            env = api.generate_proof(base, key, ct, iv, toprf=signals,
                                     mask=mask, device="cuda", rng=rng)
        torch.cuda.synchronize()
        secs = time.time() - t
        stages = " ".join(f"{k}={v:.3f}" for k, v in op.timings.items())
        log(f"phase 8 {alg} proof {i} ({label}): {secs:.3f} s ({stages})")
        if i == 2:
            launches = counts()
            peak = torch.cuda.max_memory_allocated()
            warm = env
    if op._key_dir() != store:
        raise AssertionError(f"phase 8 proved with {op._key_dir()}, not the "
                             "key made on the card")
    log(f"phase 8 {alg} warm proof launches {launches}; peak device memory "
        f"{peak / 2**30:.3f} GiB, {(peak - held) / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB allocated before the proof (the key, and "
        f"earlier phases' recorded kernel inputs)")
    for k in ("chunk_scan", "jac_add_n") + H_NAMES + GLUE_NAMES:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 f"{alg} path")
    if warm.algorithm != alg or warm.plaintext != b"":
        raise AssertionError("the -toprf envelope must carry no plaintext")
    t = time.time()
    ok = api.verify_proof(warm, ct, iv, toprf=signals, device="cuda")
    log(f"phase 8 verify: {ok} ({time.time() - t:.2f} s)")
    if not ok:
        raise AssertionError(f"the {alg} proof did not verify")
    flipped = ct[:7] + bytes([ct[7] ^ 0x04]) + ct[8:]
    plus_one = api.ZKTOPRFPublicSignals(
        signals.locations, signals.domain_separator, signals.output + 1,
        signals.responses)
    for label, c, sig in (("a ciphertext with one byte flipped", flipped,
                           signals),
                          ("the TOPRF output plus one", ct, plus_one),
                          ("the other share's response", ct, other)):
        if api.verify_proof(warm, c, iv, toprf=sig, device="cuda"):
            raise AssertionError(f"{alg}: {label} verified")
        log(f"phase 8 rejected: {label}")
    log(f"phase 8 {alg} total {time.time() - t0:.2f} s")
    return launches


def check_toprf_digests():
    """Phase 8: the three -toprf circuits compile to the digests of the
    committed manifests."""
    from zksc_tpu_torch.operators import CircuitSpec
    for alg in TOPRF_ALGS:
        t = time.time()
        cs = CircuitSpec(alg).cs
        with open(os.path.join(HERE, "artifacts", alg, "manifest.json")) as f:
            want = json.load(f)["digest"]
        log(f"phase 8 {alg} circuit: {cs.n_constraints} constraints, "
            f"{cs.n_wires} wires, digest {cs.digest()[:12]}.. "
            f"({time.time() - t:.2f} s)")
        if cs.digest() != want:
            raise AssertionError(f"{alg} digest {cs.digest()} != {want}")


def _power_circuit(n_mul: int, extra_bits: bool):
    """out == x^(n_mul+1) + x + 41 (plus an 8-bit decomposition of x + 2
    when extra_bits): the x^13 toy of tests/port/test_torch_prove.py for
    n_mul = 12."""
    def define(api, v):
        x, out = v["x"][0], v["out"][0]
        acc = x
        for _ in range(n_mul):
            acc = api.mul(acc, x)
        api.assert_eq(api.add(acc, x, api.constant(41)), out)
        if extra_bits:
            bits = api.to_bits(api.add(x, api.constant(2)), 8)
            api.assert_eq(api.from_bits(bits), api.add(x, api.constant(2)))
    return define


def drive_ladder_branch(reset_counts, counts) -> dict:
    """Phase 7. Returns the kernel launch counts of the path."""
    import random

    from zksc_tpu_torch.curve import bn254_host as host
    from zksc_tpu_torch.groth16 import ProverContext, setup, verify
    from zksc_tpu_torch.r1cs import compile_circuit, generate_witness
    pub, priv = [("out", 1)], [("x", 1)]
    reset_counts()
    for label, n_mul, extra in (("x^13 toy", 12, True), ("x^100", 99, False)):
        define = _power_circuit(n_mul, extra)
        cs = compile_circuit(define, pub, priv)
        srng = random.Random(23)
        t = time.time()
        pk, vk = setup(cs, rng=lambda: srng.randrange(2, host.R), device="cuda")
        x = 7
        out = (pow(x, n_mul + 1, host.R) + x + 41) % host.R
        wit = generate_witness(define, pub, priv, {"out": [[out]]},
                               {"x": [[x]]}, batch=1)[:, 0]
        proofs = []
        for force in (False, True):
            br = random.Random(5)
            ctx = ProverContext(cs, pk, device="cuda", force_pippenger=force)
            t1 = time.time()
            p = ctx.prove(wit, rng=lambda: br.randrange(1, host.R))
            proofs.append((p, time.time() - t1))
        ok = verify(vk, proofs[0][0], [out])
        (lad, _), (pip, _) = proofs
        same = (lad.a, lad.b, lad.c) == (pip.a, pip.b, pip.c)
        log(f"phase 7 {label}: m_pad {ctx.m_pad}, ladder proof "
            f"{proofs[0][1]:.3f} s, pippenger proof {proofs[1][1]:.3f} s, "
            f"equal {same}, verify {ok} ({time.time() - t:.2f} s with setup)")
        if not (same and ok):
            raise AssertionError(f"phase 7 {label}: ladder proof != pippenger "
                                 "proof or does not verify")
    launches = counts()
    log(f"phase 7 launches: {launches}")
    if launches["ladder"] <= 0:
        raise AssertionError("K3 was not launched on the ladder branch")
    return launches


# ------------------------------------------------------------- the stark engine

STARK_SEED = 20242        # seed of phase 9's inputs and blinding bytes
K7_REPLACES = {"blake2s": "zksc_tpu/stark/blake2s.py:79",
               "blake2s_tree": "zksc_tpu/stark/merkle.py:40",
               "circle_layer": "zksc_tpu/stark/circle.py:104",
               "circle_fft": "zksc_tpu/stark/circle.py:104",
               "composition": "zksc_tpu/stark/prover.py:236",
               "aes_composition": "zksc_tpu/stark/aes_prover.py:234"}
# the K7 kernels each stark proof must launch (K7a's tree launch counts as
# blake2s)
CHACHA_K7 = ("blake2s", "circle_layer", "composition")
AES_K7 = ("blake2s", "circle_layer", "aes_composition")
# an evaluate call of K7b replaces the reference's evaluate
K7B_EVALUATE_REPLACES = "zksc_tpu/stark/circle.py:122"
# the LAUNCHES key of each stark_kernels launcher (K7a's tree launch under
# K7a, K7b's one-launch transform under K7b), and the keys
K7_LAUNCH_KEY = {"blake2s_tree": "blake2s", "circle_fft": "circle_layer"}
K7_KEYS = ("blake2s", "circle_layer", "composition", "aes_composition")
# K7b launches a warm proof must make: one circle_fft a transform (the
# chacha20 LDE's interpolate and evaluate; AES: two LDEs; stwo: the trace's
# interpolate and evaluate, the composition's interpolate)
K7B_LAUNCHES = {"stark chacha20": 2, "stark aes": 4, "stark-stwo": 3}
# integer instructions per Blake2s compression, each issued at the integer
# rate: a G is 4 IADD3 (a + b + m is one IADD3 on sm_90, c + d another), 4
# LOP3 (the xors) and 4 SHF / PRMT (the rotates); 10 rounds x 8 G, plus the
# 8 LOP3 of the feed-forward h ^ v[i] ^ v[i + 8]
BLAKE2S_OPS = 10 * 8 * 12 + 8
# K7a's chain floor. One message's compressions chain, so a leaf takes at
# least its compressions x one compression on one warp. blake2s_kernel's
# compression loop as built for sm_90a (tools/stark_sass.py --loops, nvcc
# 12.9) issues 1,056 instructions a compression: LOP3 328, SHF.R.W 320 and
# IADD3 175 on the integer ALU pipe, IMAD.IADD 157 on the FMA pipe, 76
# loads, moves and addresses. A sub-partition's pipe takes 16 lanes a clock
# (64 a clock an SM), so a warp instruction holds it 2 clocks. The
# dependent chain is 20 half-rounds x 12 operations at the integer pipe's
# dependent-issue latency, taken as 4 clocks (assumed, not measured).
BLAKE2S_ALU_OPS, BLAKE2S_FMA_OPS = 328 + 320 + 175, 157
BLAKE2S_DEP_OPS, INT_DEP_CLOCKS = 20 * 12, 4
BLAKE2S_CHAIN_CLOCKS = max(2 * BLAKE2S_ALU_OPS, 2 * BLAKE2S_FMA_OPS,
                           BLAKE2S_DEP_OPS * INT_DEP_CLOCKS)
# issue slots of an M31 product of canonical operands (every product K7c
# and K7d form is one) and of an M31 add or subtract (add, compare,
# select): the product as m31_mulc compiles for sm_90a (K7B_EVAL_OPS'
# count: IMAD.WIDE.U32, LOP3, SHF.R.U64, IMAD.IADD, VIADDMNMX.U32). K7d forms
# its products so; K7c still reduces each by two folds and a select (10
# slots), which the bound does not charge.
M31_MUL_OPS, M31_ADD_OPS = 5, 3
# issue slots of one weighted term for the four components q, as the SASS
# of libzksc_stark.so for sm_90a shows them (tools/stark_sass.py --loops,
# nvcc 12.9). K7c and K7d multiply-add each component into a u64 (one
# IMAD.WIDE.U32) and fold it once every four terms (lo + 2 hi: SHF.R.U64,
# SHF.R.U32.HI, two LOP3, IADD3 and IMAD.X, so the four components' folds
# cost 6 a term): 4 x 1 + 6. (An earlier K7d folded every term: 4 x 6.)
K7C_TERM_OPS = K7D_TERM_OPS = 4 * 1 + 6
# issue slots of one butterfly of K7b's one-launch transform, its arithmetic
# alone, as the SASS of circle_fft_kernel for sm_90a shows it
# (tools/stark_sass.py --loops, nvcc 12.9; the shared-memory loads and
# stores and the index arithmetic are not the function's work). A
# canonical M31 product is 5: IMAD.WIDE.U32, LOP3 (lo & p), SHF.R.U64 (t >>
# 31), IMAD.IADD, VIADDMNMX.U32 (min(s, s - p)); an add 3 (IMAD.IADD,
# ISETP, a predicated VIADD), a subtract 4 (IMAD.IADD, ISETP, VIADD, a
# predicated IMAD.MOV), a halving 3 (SHF.R.U32.HI, IMAD.SHL, LOP3).
# Evaluate: tw b, a + tw b, a - tw b; interpolate: (lo + hi) / 2 and (lo -
# hi) (tw / 2), the 1/2 folded into the twiddle.
K7B_EVAL_OPS, K7B_INTERP_OPS = 5 + 3 + 4, 3 + 3 + 4 + 5
# M31 products per constraint of each group of the chacha20 AIR
K7C_PRODUCTS = (1, 0, 1, 1, 1)
# K7d, per item of each kind: M31 products, M31 adds / subtracts and
# constraints (weight rows). A cumlk item adds its four values into the
# slice's sums; each slice with cumlk items adds four terms once.
K7D_ITEM = {"bool": (1, 1, 1), "const": (0, 1, 1), "xor": (1, 3, 1),
            "mix": (0, 12, 1), "lookup": (20, 35, 4), "table": (21, 19, 4),
            "cum": (0, 8, 4), "cumlk": (0, 4, 0), "eq": (1, 4, 1)}


def seeded_bytes(seed: int):
    """rand_bytes for prove_stream: n -> n bytes from a seeded generator."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def sm_clock_hz(imad_rate):
    """The SM clock behind imad_rate (IMAD_PER_CLK_PER_SM a clock an SM)."""
    import torch
    props = torch.cuda.get_device_properties(0)
    return imad_rate / (IMAD_PER_CLK_PER_SM * props.multi_processor_count)


def k7a_chain_ms(name, args, imad_rate):
    """K7a's chain floor for one call: the compressions of one message (a
    tree launch: and one node a layer above it, up to the root) x
    BLAKE2S_CHAIN_CLOCKS over the SM clock. Returns (ms, compressions)."""
    base, count, length = args[:3]
    chain = max(1, -(-length // 64))
    if name == "blake2s_tree":
        chain += count.bit_length() - 1
    return chain * BLAKE2S_CHAIN_CLOCKS / sm_clock_hz(imad_rate) * 1e3, chain


def k7_bound_ms(name, args, imad_rate):
    """(bound ms, bound_by, work) of one K7 call from its arguments: the
    larger of the operations over the card's integer rate and the bytes
    (inputs read once, outputs written once) over HBM."""
    if name in ("blake2s", "blake2s_tree"):
        base, count, length = args[:3]
        blocks = count * max(1, -(-length // 64))
        nbytes = count * 4 * (-(-length // 4)) + 32 * count
        if name == "blake2s_tree":          # the node layers
            blocks += count - 1
            nbytes += 32 * (count - 1)
        bound, by = _bound(blocks * BLAKE2S_OPS, nbytes, imad_rate)
        return bound, by, f"{blocks} compressions"
    if name == "circle_layer":
        src, interp = args[0], args[1]
        flies = src.numel() // 2
        ops = flies * (K7B_INTERP_OPS if interp else K7B_EVAL_OPS)
        bound, by = _bound(ops, 8 * src.numel() + 4 * args[4].numel(), imad_rate)
        return bound, by, f"{flies} butterflies (one layer)"
    if name == "circle_fft":
        src, interp, log_n, tw = args[:4]
        (C, K), N = src.shape, 1 << log_n
        layers = log_n if interp else k7b_eval_layers(K, log_n)
        ops = C * layers * (N // 2) * (K7B_INTERP_OPS if interp else K7B_EVAL_OPS)
        bound, by = _bound(ops, 4 * (C * K + C * N + N), imad_rate)
        return bound, by, (f"{C} columns x {layers} layers of {N // 2} "
                           f"butterflies, {C * K} values in")
    if name == "aes_composition":
        from zksc_tpu_torch.ops import stark_kernels
        vals, perm, table, za, weights = args[:5]
        hdr, srows, n = table[0], table[1], table[2]
        M = vals.shape[1]
        counts = stark_kernels.aes_item_counts(n)
        cumlk = stark_kernels.AES_KINDS.index("cumlk")
        sum_slices = int((hdr[:, 4 + 3 * cumlk] > 0).sum())
        ops = M * (sum(counts[kind] * (p * M31_MUL_OPS + a * M31_ADD_OPS
                                       + k * K7D_TERM_OPS)
                       for kind, (p, a, k) in K7D_ITEM.items())
                   + sum_slices * 4 * (M31_ADD_OPS + K7D_TERM_OPS))
        nbytes = 4 * (vals.numel() + perm.numel() + hdr.numel() + srows.numel()
                      + weights.numel() + M + 4 * M)
        bound, by = _bound(ops, nbytes, imad_rate)
        per_item = stark_kernels.aes_item_gathers()
        gathers = M * sum(counts[k] * g for k, g in per_item.items())
        return bound, by, (f"{weights.shape[0]} constraints x {M} points in "
                           f"{hdr.shape[0]} slices, {gathers} gathers "
                           f"({4 * gathers / HBM_BYTES_PER_S * 1e3:.4f} ms of "
                           f"HBM if every gather missed the caches)")
    vals, idx, off, n, weights = args[:5]
    M = vals.shape[1]
    ops = M * sum(k * (p * M31_MUL_OPS + K7C_TERM_OPS)
                  for k, p in zip(n, K7C_PRODUCTS))
    nbytes = 4 * (vals.numel() + idx.numel() + weights.numel() + M + 4 * M)
    bound, by = _bound(ops, nbytes, imad_rate)
    gathers = idx.numel() * M
    return bound, by, (f"{sum(n)} constraints x {M} points, {gathers} "
                       f"gathers ({4 * gathers / HBM_BYTES_PER_S * 1e3:.4f} ms "
                       f"of HBM if every gather missed the caches)")


def k7b_eval_layers(K: int, log_n: int) -> int:
    """Layers of an evaluate of K coefficients (the rest zero) at N =
    2^log_n that do arithmetic in circle_fft_kernel: an x-layer whose upper
    half is still zero only copies (the values' extent doubles)."""
    ext, layers = K, 1                      # the y-layer
    for _ in range(log_n - 1):
        if ext <= (1 << log_n) // 2:
            ext *= 2
        else:
            layers += 1
    return layers


def k7_variant(name, args) -> str:
    if name in ("blake2s", "blake2s_tree"):
        base, count, length, ms, ws = args[:5]
        kind = ("columns" if ms == 1 and ws > 1 else
                "pairs" if (length, ms) == (64, 16) else "rows")
        tree = "tree " if name == "blake2s_tree" else ""
        return f"{tree}{kind} {count} x {length} B"
    if name == "circle_layer":
        src, interp, rev, log_w = args[:4]
        form = ("interpolate" if interp else "evaluate") + (
            " x-fold" if rev else " y-fold")
        return f"{form} [{src.shape[0]}, {src.shape[1]}]"
    if name == "circle_fft":
        src, interp, log_n = args[:3]
        return (f"{'interpolate' if interp else 'evaluate'} [{src.shape[0]}, "
                f"{1 << log_n}] from K={src.shape[1]}")
    return f"M={args[0].shape[1]} R={args[0].shape[0]}"


def k7_plain(name, args, key_size=None, groups=None):
    """The plain version of one K7 call on the same inputs (key_size: the
    AES AIR's, for K7d; groups: K7c's index groups, default the stark
    engine's chacha20 AIR)."""
    from zksc_tpu_torch.stark import blake2s, chacha_air, circle, prover
    if name == "blake2s":
        return blake2s.hash_strided_plain(*args)
    if name == "blake2s_tree":
        return blake2s.tree_strided_plain(*args[:5])
    if name == "circle_layer":
        return circle.layer_plain(*args)
    if name == "circle_fft":
        src, interp, log_n = args[:3]
        fft = circle.CircleFFT(log_n)
        return fft.interpolate_plain(src) if interp else fft.evaluate_plain(src)
    if name == "aes_composition":
        return k7d_plain(key_size, *args)
    vals, idx, off, n, weights, vn_inv = args[:6]
    if groups is None:
        groups = chacha_air.layout()[1]
    return prover._composition_plain(vals, groups, weights, vn_inv)


def k7d_plain(key_size, vals, perm, table, za, weights, vn_inv):
    """_composition_plain on one K7d call's inputs, over the AES AIR of
    key_size."""
    from zksc_tpu_torch.stark import aes_air, aes_prover
    return aes_prover._composition_plain(vals, perm, aes_air.layout(key_size)[2],
                                         za[:4], za[4:], weights, vn_inv)


class StarkRecorder:
    """Wraps stark_kernels' six launchers (the wrapped functions run
    unchanged); while `window` is set it keeps every call, in order, with
    its arguments (`log`), holding its inputs. key_size: the AES AIR's of
    the recorded proof (for K7d's plain version); groups: K7c's index
    groups of the recorded proof's AIR (default the stark engine's
    chacha20 AIR)."""

    NAMES = ("blake2s", "blake2s_tree", "circle_layer", "circle_fft",
             "composition", "aes_composition")

    def __init__(self, key_size=None, groups=None):
        from zksc_tpu_torch.ops import stark_kernels
        self.key_size = key_size
        self.groups = groups
        self.mod = stark_kernels
        self.orig = {n: getattr(stark_kernels, n) for n in self.NAMES}
        self.log = []
        self.window = False

    def __enter__(self):
        for name in self.NAMES:
            def call(*args, _name=name, _fn=self.orig[name]):
                if self.window:
                    self.log.append((_name, args))
                return _fn(*args)
            setattr(self.mod, name, call)
        return self

    def __exit__(self, *exc):
        for name in self.NAMES:
            setattr(self.mod, name, self.orig[name])


def hashlib_tree(msgs):
    """Every layer of the Merkle tree over the byte strings `msgs` by
    hashlib, as one int32 [2N - 1, 8] array (blake2s_tree's layout)."""
    import hashlib
    import numpy as np
    layer = [hashlib.blake2s(m, digest_size=32).digest() for m in msgs]
    out = list(layer)
    while len(layer) > 1:
        layer = [hashlib.blake2s(layer[2 * i] + layer[2 * i + 1],
                                 digest_size=32).digest()
                 for i in range(len(layer) // 2)]
        out += layer
    return np.frombuffer(b"".join(out), dtype=np.int32).reshape(-1, 8)


def check_k7a(device, words, imad_rate):
    """Phase 3 for K7a: the loose-message kernel and the tree launch over
    2,048 column leaves of 0-129,024 bytes, each equal to the plain version
    and the tree to hashlib, layer for layer; the tree over 16-byte rows
    (FRI's form) at 1-2,048 leaves, equal to the plain version and
    hashlib; then both timed at the paths' shapes (1,024 x 129,024 B, the
    stark chunk's trace; 32 x 133,120 B, the stark-stwo chunk's) beside
    K7a's chain floor. Returns the max_abs_err (0)."""
    import numpy as np
    import torch
    from zksc_tpu_torch.ops import stark_kernels
    from zksc_tpu_torch.stark import blake2s
    err = 0
    B = 2048

    def equal(label, got, want):
        e = max_abs_diff([got], [want])
        if e:
            raise AssertionError(f"{label}: kernel != plain (max_abs_err {e})")
        return e
    for length in (0, 1, 63, 64, 65, 129024):
        nw = max(1, -(-length // 4))
        src = words(nw, B)            # message i is column i: strided
        torch.cuda.synchronize()
        t = time.time()
        leaves = blake2s.hash_strided_plain(src, B, length, 1, B)
        plain = blake2s.tree_from_leaves_plain(leaves)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t) * 1e3
        host = src.cpu().numpy()
        want = hashlib_tree([np.ascontiguousarray(host[:, i]).tobytes()[:length]
                             for i in range(B)])
        if not np.array_equal(plain.cpu().numpy(), want):
            raise AssertionError(f"K7a {length} B: plain tree != hashlib")
        runs = {"loose": lambda: stark_kernels.blake2s(src, B, length, 1, B),
                "tree": lambda: stark_kernels.blake2s_tree(src, B, length, 1, B)}
        times = {}
        for what, run in runs.items():
            err = max(err, equal(f"K7a {what} {B} x {length} B", run(),
                                 leaves if what == "loose" else plain))
            times[what] = cuda_ms(run, reps=5)
        log(f"phase 3 K7a {B} column leaves x {length} B (word stride {B}): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
            + f"; plain {plain_ms:.1f} ms; each equal to the plain version, "
            f"the tree's {2 * B - 1} digests to hashlib's")
    for n in (1, 2, 128, 2048):
        rows = words(n, 4)            # FRI's 16-byte leaves
        got = stark_kernels.blake2s_tree(rows, n, 16, 4, 1)
        err = max(err, equal(f"K7a tree rows {n}", got,
                             blake2s.tree_strided_plain(rows, n, 16, 4, 1)))
        host = rows.cpu().numpy()
        if not np.array_equal(got.cpu().numpy(),
                              hashlib_tree([r.tobytes() for r in host])):
            raise AssertionError(f"K7a tree rows {n}: != hashlib")
        log(f"phase 3 K7a tree over {n} 16-byte rows: kernel "
            f"{cuda_ms(lambda: stark_kernels.blake2s_tree(rows, n, 16, 4, 1), reps=5):.4f}"
            f" ms, equal to the plain version and to hashlib, layer for layer")
    for n, length in ((1024, 129024), (32, 133120)):
        nw = length // 4
        src = words(nw, n)
        loose = stark_kernels.blake2s(src, n, length, 1, n)
        times = {}
        for what, run in (
                ("loose", lambda: stark_kernels.blake2s(src, n, length, 1, n)),
                ("tree", lambda: stark_kernels.blake2s_tree(src, n, length, 1, n))):
            err = max(err, equal(f"K7a {what} {n} x {length} B",
                                 run()[:n], loose))
            times[what] = cuda_ms(run, reps=5)
        chain, comp = k7a_chain_ms("blake2s", (src, n, length), imad_rate)
        log(f"phase 3 K7a leaves at {n} x {length} B: loose kernel "
            f"{times['loose']:.4f} ms, tree launch {times['tree']:.4f} ms (its "
            f"leaves equal the loose kernel's); chain floor {chain:.4f} ms "
            f"({comp} compressions x {BLAKE2S_CHAIN_CLOCKS} clocks); "
            + ", ".join(f"{k} {1e3 * v / comp:.4f} us" for k, v in times.items())
            + " a compression")
        del src
    return err


def check_stark_kernels(device, imad_rate):
    """Phase 3 for K7a, K7b and K7c: each equal to its plain version on the
    card, value for value (K7a's trees also to hashlib). Returns the
    max_abs_err (0)."""
    import numpy as np
    import torch
    from zksc_tpu_torch.ops import stark_kernels
    from zksc_tpu_torch.stark import chacha_air, circle, prover
    rng = np.random.default_rng(STARK_SEED)
    m31 = lambda *s: torch.from_numpy(rng.integers(0, (1 << 31) - 1, s)
                                      .astype(np.int32)).to(device)
    words = lambda *s: torch.from_numpy(rng.integers(-2**31, 2**31, s)
                                        .astype(np.int32)).to(device)
    err = check_k7a(device, words, imad_rate)
    for log_n in (3, 6, 8, 10, 11, 16, 20):
        fft = circle.CircleFFT(log_n)
        route = ("circle_fft, 1 launch" if log_n <= stark_kernels.FFT_MAX_LOG
                 else f"circle_layer, {log_n} launches")
        for C in (1, min(4096, (1 << 28) >> log_n)):
            x = m31(C, 1 << log_n)
            for what, run, plain in (
                    ("interpolate", lambda: fft.interpolate(x),
                     lambda: fft.interpolate_plain(x)),
                    ("evaluate", lambda: fft.evaluate(x),
                     lambda: fft.evaluate_plain(x))):
                ms, plain_ms, e = compare(f"K7b {what} 2^{log_n} x {C}", run,
                                          plain, lambda r: [r])
                err = max(err, e)
                log(f"phase 3 K7b {what} [{C}, 2^{log_n}]: kernel {ms:.4f} ms "
                    f"({route}), plain {plain_ms:.1f} ms, equal")
            if not torch.equal(fft.evaluate(fft.interpolate(x)), x):
                raise AssertionError(f"K7b round trip 2^{log_n} x {C}")
        del fft, x
    err = max(err, check_k7b_shapes(device, m31, imad_rate))
    n_comm, groups = chacha_air.layout()
    R, M = n_comm + chacha_air.N_PUBLIC + 1, 1024
    vals, vn_inv = m31(R, M), m31(M)
    weights = m31(prover._n_constraints(groups), 4)
    idx, off, n = prover._groups_on(device)
    ms, plain_ms, e = compare(
        "K7c", lambda: stark_kernels.composition(vals, idx, off, n, weights, vn_inv),
        lambda: prover._composition_plain(vals, groups, weights, vn_inv),
        lambda r: [r])
    log(f"phase 3 K7c composition on the chacha20 AIR at M={M} (random "
        f"values; slice, points a thread, threads a block "
        f"{stark_kernels.composition_plan(M)}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.1f} ms, equal")
    return max(err, e, check_stwo_shapes(device, m31),
               check_k7d(device, m31, imad_rate))


def k7b_lde_shapes():
    """(label, interp, C, log_n, K) of every K7b transform the proofs of
    phases 9-11 make, and the largest one-launch size: the stark chacha20
    LDE (chunk N = 64 -> M = 1,024, record 256 -> 2,048; the evaluation
    from N + 50 blinding coefficients rounded up to a multiple of 4), both
    AES LDEs (phase 1: the trace and public columns, phase 2: the
    interaction's; N = 256 -> 2,048 at the chunk, 1,024 -> 8,192 at the 16
    KiB record), stwo's (the trace's interpolate and evaluate, the
    composition's interpolate at 2n), and 2^15 (the AES prover's LDE at
    its MAX_LOG_ROWS, fewer columns)."""
    from zksc_tpu_torch.stark import aes_air, chacha_air, prover
    from zksc_tpu_torch.stark.stwo_compat import air
    cols = chacha_air.layout()[0] + chacha_air.N_PUBLIC
    k = lambda n: -(-(n + prover.ZK_COEFFS) // 4) * 4
    out = []
    for tag, log_n, log_m in (("chunk", 6, 10), ("record", 8, 11)):
        out += [(f"stark chacha20 {tag}", True, cols, log_n, 1 << log_n),
                (f"stark chacha20 {tag}", False, cols + 1, log_m, k(1 << log_n))]
    for key_size, tag, log_n in ((16, "chunk", 8), (32, "record", 10)):
        n1, n2, _ = aes_air.layout(key_size)
        for phase, c in ((1, n1 + aes_air.N_PUB), (2, n2)):
            label = f"stark aes-{8 * key_size} {tag} phase {phase}"
            out += [(label, True, c, log_n, 1 << log_n),
                    (label, False, c + 1, log_n + 3, k(1 << log_n))]
    for tag, ls in (("chunk", 4), ("record", 8)):
        out += [(f"stwo {tag}", True, air.N_COLS, ls, 1 << ls),
                (f"stwo {tag}", False, air.N_COLS + 1, ls + 1, 1 << ls),
                (f"stwo {tag} composition", True, 4, ls + 1, 1 << (ls + 1))]
    out += [("largest one launch", True, 2048, 15, 1 << 15),
            ("largest one launch", False, 2049, 15, k(4096))]
    return out


def check_k7b_shapes(device, m31, imad_rate):
    """Phase 3 for K7b at every LDE shape of phases 9-11 and at 2^15
    (k7b_lde_shapes): the one-launch transform (circle_fft) equal to the
    plain version, timed beside its bound and beside the per-layer route
    (circle_layer, one launch a layer, on the same values zero-extended)
    in the same call; then a transform above 2^FFT_MAX_LOG, which takes the
    per-layer route. Returns the max_abs_err (0)."""
    import torch
    from zksc_tpu_torch.ops import stark_kernels
    from zksc_tpu_torch.stark import circle
    err = 0
    for label, interp, C, log_n, K in k7b_lde_shapes():
        fft = circle.CircleFFT(log_n)
        x = m31(C, K)
        what = "interpolate" if interp else "evaluate"
        tw = fft.twiddles(device)["fft_interp" if interp else "fft_eval"]
        run = lambda: stark_kernels.circle_fft(x, interp, log_n, tw)
        full = fft._zero_extend(x)
        layers = lambda: fft._transform(full, interp, stark_kernels.circle_layer)
        plain = lambda: fft._plain(full, interp)
        ms, plain_ms, e = compare(f"K7b {label} {what}", run, plain, lambda r: [r])
        err = max(err, e)
        want = run()
        if not torch.equal(layers(), want):
            raise AssertionError(f"K7b {label} {what}: the per-layer route differs")
        layer_ms = cuda_ms(layers, reps=5)
        paced = cuda_ms(run, reps=3, paced=True)
        bound, by, work = k7_bound_ms("circle_fft", (x, interp, log_n, tw), imad_rate)
        log(f"phase 3 K7b {label} {what} [{C}, 2^{log_n}] from K={K}: "
            f"circle_fft {ms:.4f} ms ({paced:.4f} ms paced by the host); "
            f"circle_layer {layer_ms:.4f} ms in {log_n} launches; bound "
            f"{bound:.4f} ms ({by}; {work}); plain {plain_ms:.1f} ms; all equal")
        del x, full
    fft = circle.CircleFFT(stark_kernels.FFT_MAX_LOG + 1)
    x = m31(64, fft.n)
    before = stark_kernels.LAUNCHES["circle_layer"]
    got = fft.evaluate(x[:, :fft.n // 8])
    if stark_kernels.LAUNCHES["circle_layer"] - before != fft.log_n:
        raise AssertionError("K7b above the limit: not one launch a layer")
    e = max_abs_diff([got], [fft.evaluate_plain(x[:, :fft.n // 8])])
    if e:
        raise AssertionError(f"K7b above the limit: kernel != plain ({e})")
    log(f"phase 3 K7b above 2^{stark_kernels.FFT_MAX_LOG}: evaluate [64, "
        f"2^{fft.log_n}] from K={fft.n // 8} through circle_layer, "
        f"{fft.log_n} launches, equal to the plain version")
    return err


def check_stwo_shapes(device, m31):
    """Phase 3 at the stark-stwo engine's shapes: K7c over its AIR's groups
    (54,784 constraints, R = 33,281) at M = 32 (the 128-byte chunk) and 512
    (the 16 KiB record), each equal to its plain version on random values
    (K7b's stwo shapes are check_k7b_shapes'). Returns the max_abs_err
    (0)."""
    from zksc_tpu_torch.ops import stark_kernels
    from zksc_tpu_torch.stark import prover
    from zksc_tpu_torch.stark.stwo_compat import air
    from zksc_tpu_torch.stark.stwo_compat import prover as stwo_prover
    err = 0
    groups = air.layout()[0]
    idx, off, n, _ = stwo_prover._layout_on(device)
    for M in (32, 512):
        vals, vn_inv = m31(air.N_COLS + 1, M), m31(M)
        weights = m31(air.N_CONSTRAINTS, 4)
        ms, plain_ms, e = compare(
            f"K7c stwo M={M}",
            lambda: stark_kernels.composition(vals, idx, off, n, weights, vn_inv),
            lambda: prover._composition_plain(vals, groups, weights, vn_inv),
            lambda r: [r])
        err = max(err, e)
        log(f"phase 3 K7c composition on the stark-stwo AIR at M={M} (random "
            f"values; plan {stark_kernels.composition_plan(M)}): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.1f} ms, equal")
    return err


def check_k7d(device, m31, imad_rate):
    """Phase 3 for K7d: equal to its plain version on random values,
    challenges and weights at the AES-128 and AES-256 80-byte chunks'
    shape (log_rows 8, M = 2,048) and 16 KiB records' (log_rows 10, M =
    8,192), sigma as the prover's, in the launch shape the wrapper picks
    (aes_composition_plan: points a thread, threads a block, grid order),
    timed beside its bound. Returns the max_abs_err (0)."""
    from zksc_tpu_torch.ops import stark_kernels
    from zksc_tpu_torch.stark import aes_air, aes_prover
    err = 0
    for key_size, log_rows in ((16, 8), (32, 8), (16, 10), (32, 10)):
        n1, n2, groups = aes_air.layout(key_size)
        _, M, _ = aes_prover._domain_params(log_rows)
        vals, vn_inv = m31(n1 + n2 + aes_air.N_PUB + 1, M), m31(M)
        vals[-1] = 0
        weights = m31(aes_prover.n_constraints(key_size), 4)
        za = tuple(int(v) for v in m31(8).cpu())
        perm = aes_prover._sigma_on(log_rows, device)
        table = aes_prover._groups_on(key_size, device)
        args = (vals, perm, table, za, weights, vn_inv)
        ms, plain_ms, e = compare(
            f"K7d AES-{8 * key_size} M={M}",
            lambda: stark_kernels.aes_composition(*args),
            lambda: k7d_plain(key_size, *args), lambda r: [r])
        err = max(err, e)
        points, threads, first = stark_kernels.aes_composition_plan(M)
        paced = cuda_ms(lambda: stark_kernels.aes_composition(*args), reps=3,
                        paced=True)
        bound, by, work = k7_bound_ms("aes_composition", args, imad_rate)
        log(f"phase 3 K7d aes_composition on the AES-{8 * key_size} AIR at "
            f"M={M} ({table[0].shape[0]} slices, {points} points a thread, "
            f"{threads} threads a block, random values): kernel {ms:.4f} ms "
            f"({paced:.4f} ms paced by the host; "
            f"{'slices' if first else 'point tiles'} first); "
            f"bound {bound:.4f} ms ({by}; {work}); plain {plain_ms:.1f} ms, "
            f"equal")
        del vals, args
    return err


def sweep_merkle_crossover(device):
    """Phase 3: one whole Merkle tree of n leaves by hashlib on the host
    (merkle._commit_host) and by K7a's tree launch with its copies to the
    card and back (merkle._tree_device), host clock, for FRI's 16-byte
    leaves and for the stark-stwo composition tree's 8-word column leaves:
    where the card starts to win is merkle.DEVICE_MIN_LEAVES."""
    import numpy as np
    import torch
    from zksc_tpu_torch.stark import merkle
    rng = np.random.default_rng(STARK_SEED + 1)
    rows = {}
    for k in range(2, 13):
        n = 1 << k
        for kind in ("16-byte leaves", "8-word column leaves"):
            if kind == "16-byte leaves":
                data = rng.integers(0, 256, (n, 16), dtype=np.uint8)
                host = lambda: merkle._commit_host(data)
                card = lambda: merkle._tree_device(
                    torch.from_numpy(data.view(np.int32)).to(device), n, 16, 4, 1)
            else:
                cols = torch.from_numpy(rng.integers(0, (1 << 31) - 1, (8, n))
                                        .astype(np.int32))
                host = lambda: merkle.commit_columns(cols)
                card = lambda: merkle._tree_device(cols.to(device), n, 32, 1, n)
            if host().root != card().root:
                raise AssertionError(f"crossover sweep: {kind} {n} differ")
            reps = max(3, 2048 // n)
            times = []
            for fn in (host, card):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(reps):
                    fn()
                times.append((time.perf_counter() - t) / reps * 1e3)
            rows.setdefault(kind, []).append((n, *times))
            log(f"phase 3 Merkle tree of {n} {kind}: hashlib {times[0]:.4f} "
                f"ms, K7a's tree launch with its copies {times[1]:.4f} ms")
    for kind, rs in rows.items():
        wins = [n for n, h, c in rs if c < h]
        log(f"phase 3 Merkle crossover ({kind}): the card faster from "
            f"{min(wins) if wins else 'never'} leaves (DEVICE_MIN_LEAVES "
            f"{merkle.DEVICE_MIN_LEAVES})")


def k7b_launches(label: str, launches: dict, want: int):
    """K7b must run one launch a transform on the proofs' shapes (all below
    2^FFT_MAX_LOG): `want` launches under its key."""
    if launches["circle_layer"] != want:
        raise AssertionError(f"{label}: {launches['circle_layer']} K7b launches, "
                             f"expected {want} (one a transform)")


def drive_stark(api, reset_counts, counts, rec_api, rec_record) -> dict:
    """Phase 9: the stark engine on the card. Returns the warm API proof's
    launch counts."""
    import base64
    import numpy as np
    import torch
    from zksc_tpu_torch.ops import ciphers
    from zksc_tpu_torch.stark import prover as sp
    rnd = np.random.default_rng(STARK_SEED)
    key, iv, ct = rnd.bytes(32), rnd.bytes(12), rnd.bytes(128)
    t0 = time.time()
    t = time.time()
    api.generate_proof("chacha20", key, ct, iv, engine="stark", device="cuda")
    log(f"phase 9 stark chacha20 128-byte chunk, proof 1 (cold): "
        f"{time.time() - t:.3f} s")
    op = api.get_operator("chacha20", "stark", "cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.time()
    env = api.generate_proof("chacha20", key, ct, iv, engine="stark",
                             device="cuda")
    torch.cuda.synchronize()
    secs = time.time() - t
    launches = counts()
    peak = torch.cuda.max_memory_allocated() - held
    stages = " ".join(f"{k}={v:.3f}" for k, v in op.timings.items())
    log(f"phase 9 proof 2 (warm): {secs:.3f} s ({stages}); launches "
        f"{ {k: launches[k] for k in K7_KEYS} }; peak device "
        f"memory {peak / 2**30:.3f} GiB above {held / 2**30:.3f} GiB held; "
        f"envelope {env.proof_data['proof_size_bytes']} B")
    for k in CHACHA_K7:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the warm "
                                 f"stark proof")
    k7b_launches("phase 9 warm chunk", launches, K7B_LAUNCHES["stark chacha20"])
    with rec_api:                      # proof 3, its K7 calls kept for phase 5
        rec_api.window = True
        api.generate_proof("chacha20", key, ct, iv, engine="stark",
                           device="cuda")
        rec_api.window = False
    t = time.time()
    ok = api.verify_proof(env, ct, iv, engine="stark", device="cuda")
    log(f"phase 9 verify_proof(engine='stark'): {ok} ({time.time() - t:.2f} s)")
    if not ok:
        raise AssertionError("the port's stark verifier rejected the proof")
    bad_ct = bytes([ct[0] ^ 1]) + ct[1:]
    raw = bytearray(base64.b64decode(env.proof_data["proof"]))
    raw[len(raw) // 2] ^= 1
    bad_env = api.ProofEnvelope(env.algorithm, dict(
        env.proof_data, proof=base64.b64encode(bytes(raw)).decode()),
        env.plaintext, env.data_len)
    for label, e, c in (("a flipped ciphertext byte", env, bad_ct),
                        ("a flipped byte of the bincode payload", bad_env, ct)):
        if api.verify_proof(e, c, iv, engine="stark", device="cuda"):
            raise AssertionError(f"phase 9: {label} verified")
        log(f"phase 9 rejected: {label}")

    # a 16 KiB TLS record: 256 blocks, N = 256, M = 2,048
    pt = rnd.bytes(16384)
    rct = ciphers.chacha20_encrypt(key, iv, 1, pt)
    for i in (1, 2):
        timings = {}
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.time()
        proof = sp.prove_stream(key, iv, 1, pt, rct, device="cuda",
                                timings=timings)
        torch.cuda.synchronize()
        secs = time.time() - t
        rl = counts()
        peak = torch.cuda.max_memory_allocated() - held
        log(f"phase 9 16 KiB record (256 blocks), proof {i}: {secs:.3f} s ("
            + " ".join(f"{k}={v:.3f}" for k, v in timings.items())
            + f"); launches { {k: rl[k] for k in K7_KEYS} }; peak "
            f"device memory {peak / 2**30:.3f} GiB")
    if min(rl[k] for k in CHACHA_K7) <= 0:
        raise AssertionError("a K7 kernel was not launched by the record proof")
    k7b_launches("phase 9 record", rl, K7B_LAUNCHES["stark chacha20"])
    with rec_record:                   # proof 3, its K7 calls kept for phase 5
        rec_record.window = True
        sp.prove_stream(key, iv, 1, pt, rct, device="cuda")
        rec_record.window = False
    t = time.time()
    if not sp.verify_stream(proof, iv, 1, pt, rct, device="cuda"):
        raise AssertionError("the 16 KiB record's proof did not verify")
    log(f"phase 9 16 KiB record verified ({time.time() - t:.2f} s)")

    # the card's envelope equals the CPU's (plain versions, hashlib) under
    # one seeded source of blinding bytes
    pt128 = ciphers.chacha20_encrypt(key, iv, 1, ct)
    envs = {}
    for dev in ("cuda", "cpu"):
        t = time.time()
        envs[dev] = sp.prove_stream(key, iv, 1, pt128, ct, device=dev,
                                    rand_bytes=seeded_bytes(STARK_SEED)
                                    ).to_envelope()
        log(f"phase 9 seeded proof on {dev}: {time.time() - t:.3f} s")
    if envs["cuda"] != envs["cpu"]:
        raise AssertionError("the card's envelope differs from the CPU's")
    log(f"phase 9 card and CPU envelopes equal byte for byte "
        f"({envs['cpu']['proof_size_bytes']} B); phase 9 total "
        f"{time.time() - t0:.2f} s")
    return launches


def drive_stark_aes(api, reset_counts, counts, recs) -> dict:
    """Phase 10: the stark engine for aes-128-ctr and aes-256-ctr on the
    card. recs: {path: StarkRecorder} for the proofs kept for phase 5.
    Returns the warm aes-128-ctr API proof's launch counts."""
    import base64
    import numpy as np
    import torch
    from zksc_tpu_torch.ops import ciphers
    from zksc_tpu_torch.stark import aes_prover as ap
    rnd = np.random.default_rng(STARK_SEED + 10)
    t0 = time.time()
    main_launches = None
    for alg, key_size in (("aes-128-ctr", 16), ("aes-256-ctr", 32)):
        key, iv, ct = rnd.bytes(key_size), rnd.bytes(12), rnd.bytes(80)
        t = time.time()
        api.generate_proof(alg, key, ct, iv, engine="stark", device="cuda")
        log(f"phase 10 stark {alg} 80-byte chunk, proof 1 (cold): "
            f"{time.time() - t:.3f} s")
        op = api.get_operator(alg, "stark", "cuda")
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.time()
        env = api.generate_proof(alg, key, ct, iv, engine="stark", device="cuda")
        torch.cuda.synchronize()
        secs = time.time() - t
        launches = counts()
        peak = torch.cuda.max_memory_allocated() - held
        stages = " ".join(f"{k}={v:.3f}" for k, v in op.timings.items())
        log(f"phase 10 {alg} proof 2 (warm): {secs:.3f} s ({stages}); "
            f"launches { {k: launches[k] for k in K7_KEYS} }; peak "
            f"device memory {peak / 2**30:.3f} GiB above {held / 2**30:.3f} "
            f"GiB held; envelope {env.proof_data['proof_size_bytes']} B")
        for k in AES_K7:
            if launches[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched by the warm "
                                     f"{alg} stark proof")
        k7b_launches(f"phase 10 {alg} warm chunk", launches, K7B_LAUNCHES["stark aes"])
        if alg == "aes-128-ctr":
            main_launches = launches
        rec = recs.get(f"stark {alg} 80 B")
        if rec is not None:            # proof 3, its K7 calls kept for phase 5
            with rec:
                rec.window = True
                api.generate_proof(alg, key, ct, iv, engine="stark", device="cuda")
                rec.window = False
        t = time.time()
        ok = api.verify_proof(env, ct, iv, engine="stark", device="cuda")
        log(f"phase 10 {alg} verify_proof(engine='stark'): {ok} "
            f"({time.time() - t:.2f} s)")
        if not ok:
            raise AssertionError(f"the port's stark verifier rejected the {alg} proof")
        raw = bytearray(base64.b64decode(env.proof_data["proof"]))
        raw[len(raw) // 2] ^= 1
        bad_env = api.ProofEnvelope(env.algorithm, dict(
            env.proof_data, proof=base64.b64encode(bytes(raw)).decode()),
            env.plaintext, env.data_len)
        for label, e, c in (("a flipped ciphertext byte", env,
                             bytes([ct[0] ^ 1]) + ct[1:]),
                            ("a flipped byte of the bincode payload", bad_env, ct)):
            if api.verify_proof(e, c, iv, engine="stark", device="cuda"):
                raise AssertionError(f"phase 10 {alg}: {label} verified")
            log(f"phase 10 {alg} rejected: {label}")

        # a 16 KiB TLS record: 1,024 blocks, N = 1,024, M = 8,192
        pt = rnd.bytes(16384)
        rct = ciphers.aes_ctr_encrypt(key, iv, 2, pt)
        for i in (1, 2):
            timings = {}
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t = time.time()
            proof = ap.prove_aes_ctr(key, iv, 2, pt, rct, device="cuda",
                                     timings=timings)
            torch.cuda.synchronize()
            secs = time.time() - t
            rl = counts()
            peak = torch.cuda.max_memory_allocated() - held
            log(f"phase 10 {alg} 16 KiB record (1,024 blocks), proof {i}: "
                f"{secs:.3f} s ("
                + " ".join(f"{k}={v:.3f}" for k, v in timings.items())
                + f"); launches { {k: rl[k] for k in K7_KEYS} }; "
                f"peak device memory {peak / 2**30:.3f} GiB; envelope "
                f"{proof.to_envelope()['proof_size_bytes']} B")
        if min(rl[k] for k in AES_K7) <= 0:
            raise AssertionError(f"a K7 kernel was not launched by the {alg} "
                                 f"record proof")
        k7b_launches(f"phase 10 {alg} record", rl, K7B_LAUNCHES["stark aes"])
        rec = recs.get(f"stark {alg} 16 KiB")
        if rec is not None:            # proof 3, its K7 calls kept for phase 5
            with rec:
                rec.window = True
                ap.prove_aes_ctr(key, iv, 2, pt, rct, device="cuda")
                rec.window = False
        t = time.time()
        if not ap.verify_aes_ctr(proof, iv, 2, pt, rct, key_size, device="cuda"):
            raise AssertionError(f"the {alg} 16 KiB record's proof did not verify")
        log(f"phase 10 {alg} 16 KiB record verified ({time.time() - t:.2f} s)")

    # the card's aes-128-ctr envelope equals the CPU's (plain versions,
    # hashlib) under one seeded source of blinding bytes
    key, iv = rnd.bytes(16), rnd.bytes(12)
    pt = rnd.bytes(80)
    ct = ciphers.aes_ctr_encrypt(key, iv, 2, pt)
    envs = {}
    for dev in ("cuda", "cpu"):
        t = time.time()
        envs[dev] = ap.prove_aes_ctr(key, iv, 2, pt, ct, device=dev,
                                     rand_bytes=seeded_bytes(STARK_SEED)
                                     ).to_envelope()
        log(f"phase 10 seeded aes-128-ctr proof on {dev}: {time.time() - t:.3f} s")
    if envs["cuda"] != envs["cpu"]:
        raise AssertionError("the card's aes-128-ctr envelope differs from the CPU's")
    log(f"phase 10 card and CPU aes-128-ctr envelopes equal byte for byte "
        f"({envs['cpu']['proof_size_bytes']} B); phase 10 total "
        f"{time.time() - t0:.2f} s")
    return main_launches


STWO_SEED = 20243         # seed of phase 11's inputs
# the committed upstream stwo proofs and their plaintexts (key range(32),
# nonce range(12), counter 1)
STWO_FIXTURES = {"ls4": bytes((i * 7 + 3) & 0xFF for i in range(64)),
                 "ls5": bytes((i * 11 + 5) & 0xFF for i in range(64 * 17))}


def drive_stwo(api, reset_counts, counts, rec_api, rec_record) -> dict:
    """Phase 11: the stark-stwo engine on the card. Returns the warm API
    proof's launch counts."""
    import base64
    import gzip
    import numpy as np
    import torch
    from zksc_tpu_torch.ops import ciphers
    from zksc_tpu_torch.stark.stwo_compat import prover as wp
    from zksc_tpu_torch.stark.stwo_compat import verifier as wv
    t0 = time.time()
    key, nonce = bytes(range(32)), bytes(range(12))
    for tag, pt in STWO_FIXTURES.items():
        path = os.path.join(HERE, "tests", "fixtures",
                            f"stwo_ref_proof_chacha_{tag}.bin.gz")
        with gzip.open(path, "rb") as f:
            want = f.read()
        ct = ciphers.chacha20_encrypt(key, nonce, 1, pt)
        t = time.time()
        got = wp.prove_stream_bytes(key, nonce, 1, pt, ct, device="cuda")
        if got != want:
            raise AssertionError(f"phase 11: the {tag} proof differs from the "
                                 f"upstream fixture")
        log(f"phase 11 stwo fixture {tag} ({len(pt) // 64} blocks) proved on "
            f"the card: equal to the upstream proof byte for byte ({len(got)} "
            f"B, {time.time() - t:.3f} s)")

    rnd = np.random.default_rng(STWO_SEED)
    key, iv, ct = rnd.bytes(32), rnd.bytes(12), rnd.bytes(128)
    t = time.time()
    api.generate_proof("chacha20", key, ct, iv, engine="stark-stwo", device="cuda")
    log(f"phase 11 stark-stwo chacha20 128-byte chunk, proof 1 (cold): "
        f"{time.time() - t:.3f} s")
    op = api.get_operator("chacha20", "stark-stwo", "cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.time()
    env = api.generate_proof("chacha20", key, ct, iv, engine="stark-stwo",
                             device="cuda")
    torch.cuda.synchronize()
    secs = time.time() - t
    launches = counts()
    peak = torch.cuda.max_memory_allocated() - held
    stages = " ".join(f"{k}={v:.3f}" for k, v in op.timings.items())
    log(f"phase 11 proof 2 (warm): {secs:.3f} s ({stages}); launches "
        f"{ {k: launches[k] for k in K7_KEYS} }; peak device "
        f"memory {peak / 2**30:.3f} GiB above {held / 2**30:.3f} GiB held; "
        f"envelope {env.proof_data['proof_size_bytes']} B")
    for k in CHACHA_K7:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the warm "
                                 f"stark-stwo proof")
    k7b_launches("phase 11 warm chunk", launches, K7B_LAUNCHES["stark-stwo"])
    with rec_api:                      # proof 3, its K7 calls kept for phase 5
        rec_api.window = True
        env3 = api.generate_proof("chacha20", key, ct, iv, engine="stark-stwo",
                                  device="cuda")
        rec_api.window = False
    if env3.proof_data != env.proof_data:
        raise AssertionError("phase 11: two proofs of one chunk differ")
    t = time.time()
    ok = api.verify_proof(env, ct, iv, engine="stark-stwo", device="cuda")
    log(f"phase 11 verify_proof(engine='stark-stwo'): {ok} "
        f"({time.time() - t:.2f} s)")
    if not ok:
        raise AssertionError("the port's stwo verifier rejected the proof")
    raw = bytearray(base64.b64decode(env.proof_data["proof"]))
    raw[len(raw) // 2] ^= 1
    bad_env = api.ProofEnvelope(env.algorithm, dict(
        env.proof_data, proof=base64.b64encode(bytes(raw)).decode()),
        env.plaintext, env.data_len)
    for label, e, c in (("a flipped ciphertext byte", env,
                         bytes([ct[0] ^ 1]) + ct[1:]),
                        ("a flipped byte of the base64 payload", bad_env, ct)):
        t = time.time()
        if api.verify_proof(e, c, iv, engine="stark-stwo", device="cuda"):
            raise AssertionError(f"phase 11: {label} verified")
        log(f"phase 11 rejected: {label} ({time.time() - t:.2f} s)")

    # a 16 KiB TLS record: 256 blocks, log size 8 (n = 256, 2n = 512)
    pt = rnd.bytes(16384)
    rct = ciphers.chacha20_encrypt(key, iv, 1, pt)
    for i in (1, 2):
        timings = {}
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.time()
        proof = wp.prove_stream_bytes(key, iv, 1, pt, rct, device="cuda",
                                      timings=timings)
        torch.cuda.synchronize()
        secs = time.time() - t
        rl = counts()
        peak = torch.cuda.max_memory_allocated() - held
        log(f"phase 11 16 KiB record (256 blocks), proof {i}: {secs:.3f} s ("
            + " ".join(f"{k}={v:.3f}" for k, v in timings.items())
            + f"); launches { {k: rl[k] for k in K7_KEYS} }; peak "
            f"device memory {peak / 2**30:.3f} GiB; proof {len(proof)} B")
        if min(rl[k] for k in CHACHA_K7) <= 0:
            raise AssertionError("a K7 kernel was not launched by the stwo "
                                 "record proof")
        k7b_launches(f"phase 11 record proof {i}", rl, K7B_LAUNCHES["stark-stwo"])
    with rec_record:                   # proof 3, its K7 calls kept for phase 5
        rec_record.window = True
        wp.prove_stream_bytes(key, iv, 1, pt, rct, device="cuda")
        rec_record.window = False
    t = time.time()
    if not wv.verify_stream_proof_bytes(proof, iv, 1, pt, rct):
        raise AssertionError("the 16 KiB record's stwo proof did not verify")
    log(f"phase 11 16 KiB record verified by the port's verifier "
        f"({time.time() - t:.2f} s)")
    bad = rct[:5] + bytes([rct[5] ^ 4]) + rct[6:]
    if wv.verify_stream_proof_bytes(proof, iv, 1, pt, bad):
        raise AssertionError("phase 11: the record verified a flipped ciphertext")
    t = time.time()
    cpu = wp.prove_stream_bytes(key, iv, 1, pt, rct, device="cpu")
    log(f"phase 11 16 KiB record on the CPU (plain versions, hashlib): "
        f"{time.time() - t:.3f} s")
    if cpu != proof:
        raise AssertionError("the card's stwo record proof differs from the CPU's")
    log(f"phase 11 card and CPU record proofs equal byte for byte "
        f"({len(proof)} B)")

    # the host tables a proof builds once (the AIR's layout) or once a log
    # size (CircleFFT's domain and twiddles, the row maps, the commitment
    # domain), in the first proof that needs them: rebuilt here to time them
    from zksc_tpu_torch.stark.stwo_compat import air, cfft
    dev = torch.device("cuda")
    air._LAYOUT.clear()
    for f in (wp._layout_on, cfft.fft, cfft.row_map, cfft._maps_on,
              wp._commit_domain_on):
        f.cache_clear()
    t = time.time()
    wp._layout_on(dev)
    torch.cuda.synchronize()
    secs = [f"AIR layout {time.time() - t:.3f} s"]
    for ls in (4, 8):
        t = time.time()
        cfft._maps_on(ls, dev)
        wp._commit_domain_on(ls, dev)
        torch.cuda.synchronize()
        secs.append(f"log size {ls} and {ls + 1} domains {time.time() - t:.3f} s")
    log(f"phase 11 host tables, rebuilt to time them: {', '.join(secs)}; "
        f"phase 11 total {time.time() - t0:.2f} s")
    return launches


# ------------------------------------------------------------- phase 12: interop

INTEROP_SEED = 20244      # seed of phase 12's inputs


class _Cbor:
    """A CBOR tag for the toy .r1cs trailer."""

    def __init__(self, tag: int, value):
        self.tag, self.value = tag, value


def _cbor(o) -> bytes:
    def head(major, n):
        if n < 24:
            return bytes([major << 5 | n])
        for ai, size in ((24, 1), (25, 2), (26, 4), (27, 8)):
            if n < 1 << (8 * size):
                return bytes([major << 5 | ai]) + n.to_bytes(size, "big")
        raise ValueError("CBOR head too large")
    if o is None or isinstance(o, bool):
        return {False: b"\xf4", True: b"\xf5", None: b"\xf6"}[o]
    if isinstance(o, _Cbor):
        return head(6, o.tag) + _cbor(o.value)
    if isinstance(o, int):
        return head(0, o) if o >= 0 else head(1, -1 - o)
    if isinstance(o, str):
        return head(3, len(o.encode())) + o.encode()
    if isinstance(o, list):
        return head(4, len(o)) + b"".join(_cbor(v) for v in o)
    return head(5, len(o)) + b"".join(_cbor(k) + _cbor(v) for k, v in o.items())


def _leb128(v: int) -> bytes:
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _intcomp(values, word_bits: int) -> bytes:
    """An intcomp stream (u64 word count, then the words): bit-packed
    blocks of 4 x word_bits deltas (zigzag where a group has a negative
    one), then the varint tail; a bare tail without a full block."""
    import numpy as np
    vals = [int(v) for v in values]
    lanes, wmask = word_bits, (1 << word_bits) - 1
    n_packed = len(vals) // (4 * lanes) * (4 * lanes)
    blocks = []
    for b0 in range(0, n_packed, 4 * lanes):
        hdr, payload = 0, []
        for g in range(4):
            lo = b0 + g * lanes
            d = [vals[i] - (vals[i - 1] if i else vals[0])
                 for i in range(lo, lo + lanes)]
            zz = any(x < 0 for x in d)
            if zz:
                d = [2 * x if x >= 0 else -2 * x - 1 for x in d]
            width = max(d).bit_length()
            hdr |= ((0x80 if zz else 0) | width) << (8 * (3 - g))
            acc = sum(x << (j * width) for j, x in enumerate(d))
            payload += [(acc >> (k * word_bits)) & wmask for k in range(width)]
        blocks += [hdr] + payload
    rem = vals[n_packed:]
    raw = b"".join(_leb128(d) for d in (
        [rem[0]] + [(rem[i] - rem[i - 1]) & wmask for i in range(1, len(rem))]
        if rem else []))
    nb = word_bits // 8
    raw += bytes(-len(raw) % nb)
    data = [int.from_bytes(raw[i:i + nb], "big") for i in range(0, len(raw), nb)]
    if word_bits == 32:
        tail = [len(rem), 2 + len(data)] + data + [2 + len(data)]
    else:
        tail = [len(rem) | (1 + len(data)) << 32] + data + [1 + len(data)]
    if n_packed:
        head = [n_packed, 0, vals[0]] if word_bits == 32 else [n_packed, vals[0]]
        off = len(head) + len(blocks)
        if word_bits == 32:
            head[1] = off
        else:
            head[0] |= off << 32
        words = head + blocks + (tail if rem else [off])
    else:
        words = tail
    dt = "<u4" if word_bits == 32 else "<u8"
    return len(words).to_bytes(8, "little") + np.asarray(
        words, dtype=np.uint64).astype(dt).tobytes()


def gnark_toy_r1cs(R: int, hint_nbits: int, tag_r1c: int, tag_hint: int,
                   n_chain: int = 6, n_checks: int = 110):
    """A gnark v0.14 .r1cs (the layout of interop/gnark_r1cs.py) of
    Y = X^(n_chain+1) + 5 for an 8-bit secret X: an nBits hint splits X
    into bits (booleanity and recomposition constrained), a chain of
    products, unknowns solved in the L and the R slot, a final check with a
    -1 coefficient and n_checks booleanity re-checks, so that the 129
    instructions' u32 columns hold a packed block. The writer of
    tests/port/test_torch_gnark_r1cs.py. Returns (bytes, x -> (public,
    secret))."""
    import numpy as np
    X, Y, B0 = 2, 1, 3
    t = lambda j: 10 + j
    u, v = 11 + n_chain, 12 + n_chain
    coeffs = [0, 1, 2, 4, 8, 16, 32, 64, 128, 5, R - 1]
    c1, c5, cm1 = 1, 9, 10
    recs, kinds = [[8, hint_nbits, 1, 1, c1, X, B0, B0 + 8]], [1]

    def r1c(L, Rt, O):
        body = [len(L), len(Rt), len(O)] + [x for lc in (L, Rt, O)
                                             for term in lc for x in term]
        recs.append([1 + len(body)] + body)
        kinds.append(0)
    for k in range(8):
        r1c([(c1, B0 + k)], [(c1, B0 + k)], [(c1, B0 + k)])
    r1c([(1 + k, B0 + k) for k in range(8)], [(c1, 0)], [(c1, X)])
    r1c([(c1, X)], [(c1, X)], [(c1, t(1))])
    for j in range(2, n_chain + 1):
        r1c([(c1, t(j - 1))], [(c1, X)], [(c1, t(j))])
    r1c([(c1, u)], [(c1, X)], [(c1, t(1))])
    r1c([(c1, X)], [(c1, v)], [(c1, t(2))])
    r1c([(c1, t(n_chain)), (c5, 0), (cm1, u), (c1, X)], [(c1, 0)], [(c1, Y)])
    for k in range(n_checks):
        r1c([(2, B0 + k % 8)], [(c1, B0 + k % 8)], [(2, B0 + k % 8)])
    n = len(recs)
    calldata = [x for rec in recs for x in rec]
    levels = [[0], list(range(1, 10)), list(range(10, n))]
    s1 = len(levels).to_bytes(8, "little") + b"".join(
        _intcomp(lv, 32) for lv in levels)
    s2 = (_intcomp(kinds, 32)
          + _intcomp(np.cumsum([0] + [1 - k for k in kinds[:-1]]).tolist(), 32)
          + _intcomp(np.cumsum([0, 8] + [1] * (n - 2)).tolist(), 32)
          + _intcomp(np.cumsum([0] + [len(r) for r in recs[:-1]]).tolist(), 64))
    s3 = len(calldata).to_bytes(8, "little") + b"".join(
        _leb128(x) for x in calldata)
    s4 = _cbor({"GnarkVersion": "0.14.0", "ScalarField": format(R, "x"),
                "NbConstraints": n - 1, "NbInternalVariables": 8 + n_chain + 2,
                "Public": ["1", "Y"], "Secret": ["X"],
                "Blueprints": [_Cbor(tag_r1c, {}), _Cbor(tag_hint, {})],
                "MHintsDependencies": {hint_nbits: "std/math/bits.nBits"}})
    mont = (1 << 256) % R
    table = len(coeffs).to_bytes(8, "little") + b"".join(
        (c * mont % R).to_bytes(32, "little") for c in coeffs)
    body = (b"".join(x.to_bytes(8, "little") for x in (0, 14, 0))
            + b"".join(len(s).to_bytes(8, "little") for s in (s1, s2, s3, s4))
            + s1 + s2 + s3 + s4 + table)
    data = (len(body) + 8 - 32).to_bytes(8, "little") + body
    return data, lambda x: ({"Y": (pow(x, n_chain + 1, R) + 5) % R}, {"X": x})


def drive_interop(api, key, ct, iv, env, rng, reset_counts, counts) -> dict:
    """Phase 12: the interop layer at full width on the card. (a) phase 4's
    warm chacha20 proof and the committed key through the gnark proof / vk
    codecs and the snarkjs vkey JSON and .wtns; (b) the key's .zkey;
    (c) an imported gnark .r1cs set up, proved and verified on the card;
    (d) the AES-256 keystream of a 16 KiB record on the card; (e) LimbField
    inv / mont_pow / mont_sqr over 2^16 Fr elements; (f) trace_span around
    one warm proof. Returns the launches of (c)."""
    import random
    import struct

    import numpy as np
    import torch

    from zksc_tpu_torch.curve import bn254_host as host
    from zksc_tpu_torch.fields.limb import Fp, Fr
    from zksc_tpu_torch.groth16 import ProverContext, setup, verify
    from zksc_tpu_torch.groth16.prove import Proof
    from zksc_tpu_torch.interop import gnark, gnark_r1cs, snarkjs
    from zksc_tpu_torch.ops import ec
    from zksc_tpu_torch.ops.ciphers import aes_ctr_encrypt, aes_ctr_keystream
    from zksc_tpu_torch.ops.ntt import bit_reverse_perm
    from zksc_tpu_torch.utils.logging import Logger, trace_span
    t0 = time.time()
    op = api.get_operator("chacha20", "groth16", "cuda")
    pk, vk, cs = op._ctx.pk, op.ensure_vk(), op.spec.cs

    # (a) the card's proof through gnark's and snarkjs' formats
    proof = Proof.from_json_dict(env.proof_data)
    pub = api.get_public_signals("chacha20", ct, iv, env.plaintext)
    bad = api.get_public_signals("chacha20", bytes([ct[0] ^ 1]) + ct[1:], iv,
                                 env.plaintext)
    t = time.time()
    proof_bin = gnark.write_proof(proof)
    proof2 = gnark.parse_proof(proof_bin)
    vk_bin = gnark.write_vk(gnark.zksc_to_gnark_vk(vk, pk))
    vk_g = gnark.vk_to_zksc(gnark.parse_vk(vk_bin))
    codec_s = time.time() - t
    if (proof2.a, proof2.b, proof2.c) != (proof.a, proof.b, proof.c):
        raise AssertionError("phase 12: gnark proof round trip differs")
    t = time.time()
    vkey_text = json.dumps(snarkjs.vkey_to_json(vk))
    vk_s = snarkjs.vkey_from_json(json.loads(vkey_text))
    json_s = time.time() - t
    for label, k in (("gnark", vk_g), ("snarkjs", vk_s)):
        t = time.time()
        if not verify(k, proof2, pub):
            raise AssertionError(f"phase 12: the {label}-imported vk rejected "
                                 "the card's proof")
        if verify(k, proof2, bad):
            raise AssertionError(f"phase 12: the {label}-imported vk accepted "
                                 "a flipped ciphertext byte")
        log(f"phase 12 {label}-imported vk: proof verifies, flipped "
            f"ciphertext byte rejected ({time.time() - t:.2f} s)")
    t = time.time()
    wit = op.spec.build_witness(api.generate_zk_witness("chacha20", key, ct, iv))
    wtns = snarkjs.write_wtns(wit)
    if snarkjs.read_wtns(wtns) != [int(w) % host.R for w in wit]:
        raise AssertionError("phase 12: .wtns round trip differs")
    log(f"phase 12 codecs: gnark proof {len(proof_bin)} B, gnark vk "
        f"{len(vk_bin)} B (write+parse of both {codec_s:.3f} s), snarkjs "
        f"vkey JSON {len(vkey_text)} B ({json_s:.3f} s), .wtns of "
        f"{len(wit)} wires {len(wtns)} B (witness, write, read "
        f"{time.time() - t:.3f} s)")

    # (b) the key's .zkey, read back against the key's own points
    class Sections(Logger):
        def __init__(self):
            super().__init__()
            self.rows = []

        def log(self, level, msg, **fields):
            self.rows.append(fields)

    secs = Sections()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()      # held by phases 4-11
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    zkey = snarkjs.write_zkey(cs, pk, vk, logger=secs)
    write_s = time.time() - t
    t = time.time()
    z = snarkjs.read_zkey(zkey, device="cuda")
    read_s = time.time() - t
    peak = torch.cuda.max_memory_allocated()
    t = time.time()
    n = cs.n_wires
    head = lambda q, k: ec.JacPoint(*(c[:, :k] for c in q))
    g1 = lambda q, k: ec.g1_jac_to_host_affine(Fp, head(q, k), host.P)
    h_br = g1(pk.h_query, pk.domain_n)
    br = bit_reverse_perm(pk.domain_n)
    h_nat = [None] * pk.domain_n
    for i in range(pk.domain_n):
        h_nat[int(br[i])] = h_br[i]
    want = {"a_query": g1(pk.a_query, n), "b_g1_query": g1(pk.b_g1_query, n),
            "b_g2_query": ec.g2_jac_to_host_affine(
                Fp, pk.b_g2_query, host.P)[:n],
            "c_query": g1(pk.c_query, n - cs.n_public - 1), "h_query": h_nat,
            "ic": vk.ic,
            "coeffs": [(m, k, w, c % host.R)
                       for k, (la, lb, _) in enumerate(cs.constraints)
                       for m, lc in ((0, la), (1, lb)) for w, c in lc.items()]}
    for name, pts in want.items():
        if z[name] != pts:
            raise AssertionError(f"phase 12: the zkey's {name} differs from "
                                 "the key")
    if (z["n_vars"], z["domain_size"], z["delta_g2"]) != (
            n, pk.domain_n, pk.delta_g2):
        raise AssertionError("phase 12: the zkey header differs from the key")
    # a B2 point on the twist outside the r-torsion: the order check on the
    # card must reject it
    b2c = gnark._b2()
    for x0 in range(1, 50):
        x = (x0, 0)
        x3 = gnark._fp2_mul(gnark._fp2_mul(x, x), x)
        y = gnark._fp2_sqrt(((x3[0] + b2c[0]) % host.P,
                             (x3[1] + b2c[1]) % host.P))
        if y is not None and not host.g2_in_subgroup((x, y)):
            break
    off = 12                                  # the B2 section (type 7)
    while struct.unpack_from("<I", zkey, off)[0] != 7:
        off += 12 + struct.unpack_from("<Q", zkey, off + 4)[0]
    off += 12 + 128 * 7
    bad_b2 = zkey[:off] + snarkjs._g2_bytes((x, y)) + zkey[off + 128:]
    try:
        snarkjs.read_zkey(bad_b2, device="cuda")
        raise AssertionError("phase 12: a B2 point outside the subgroup was "
                             "read")
    except snarkjs.SnarkjsFormatError:
        pass
    log(f"phase 12 zkey of the chacha20 key: {len(zkey)} B, write_zkey "
        f"{write_s:.2f} s (" + ", ".join(
            f"{r['section']} {r['seconds']:.2f} s" for r in secs.rows)
        + f"), read_zkey {read_s:.2f} s (B2 order check on the card), equal "
        f"to the key's host-affine points and A/B rows ({time.time() - t:.2f}"
        f" s); a B2 point outside the subgroup rejected; peak device memory "
        f"{peak / 2**30:.3f} GiB, {(peak - base) / 2**30:.3f} GiB above the "
        f"{base / 2**30:.3f} GiB held before write_zkey")

    # (c) an imported gnark circuit, proved on the card
    t = time.time()
    data, assign = gnark_toy_r1cs(host.R, gnark_r1cs.HINT_NBITS,
                                  gnark_r1cs.TAG_GENERIC_R1C,
                                  gnark_r1cs.TAG_GENERIC_HINT)
    g = gnark_r1cs.parse_r1cs(data)
    pub_in, sec_in = assign(201)
    w = g.solve_witness(pub_in, sec_in)
    if not g.check_witness(w):
        raise AssertionError("phase 12: the solved gnark witness fails")
    gcs = g.to_constraint_system()
    parse_s = time.time() - t
    srng = random.Random(INTEROP_SEED)
    torch.cuda.synchronize()
    reset_counts()
    t = time.time()
    gpk, gvk = setup(gcs, rng=lambda: srng.randrange(2, host.R), device="cuda")
    setup_s = time.time() - t
    t = time.time()
    ctx = ProverContext(gcs, pk=gpk, device="cuda")
    gproof = ctx.prove(np.asarray(w, dtype=object),
                       rng=lambda: srng.randrange(1, host.R))
    torch.cuda.synchronize()
    prove_s = time.time() - t
    launches = counts()
    t = time.time()
    if not verify(gvk, gproof, [pub_in["Y"]]):
        raise AssertionError("phase 12: the imported circuit's proof failed")
    if verify(gvk, gproof, [(pub_in["Y"] + 1) % host.R]):
        raise AssertionError("phase 12: a tampered public input verified")
    log(f"phase 12 imported gnark .r1cs ({len(data)} B, {g.n_instructions} "
        f"instructions, {gcs.n_constraints} constraints, {gcs.n_wires} wires): "
        f"parse+solve {parse_s:.3f} s, setup {setup_s:.3f} s, prove "
        f"{prove_s:.3f} s (m_pad {ctx.m_pad}), verify + tampered input "
        f"rejected {time.time() - t:.2f} s; launches K1 "
        f"{launches['chunk_scan']}, K2 {launches['jac_add_n']}, K3 "
        f"{launches['ladder']}")
    for k in ("jac_add_n", "ladder"):
        if launches[k] <= 0:
            raise AssertionError(f"phase 12: {k} was not launched for the "
                                 "imported circuit")

    # (d) the AES-256 keystream of a 16 KiB record, on the card
    rnd = random.Random(INTEROP_SEED)
    akey = bytes(rnd.randrange(256) for _ in range(32))
    nonce = bytes(rnd.randrange(256) for _ in range(12))
    ctr0 = 2
    nonces = torch.tensor(list(nonce), dtype=torch.uint8,
                          device="cuda").expand(1024, 12)
    ctrs = torch.arange(ctr0, ctr0 + 1024, device="cuda")
    aes_ctr_keystream(akey, nonces, ctrs)                   # warm
    torch.cuda.synchronize()
    t = time.time()
    ks = aes_ctr_keystream(akey, nonces, ctrs)
    torch.cuda.synchronize()
    ks_s = time.time() - t
    if ks.cpu().numpy().tobytes() != aes_ctr_encrypt(akey, nonce, ctr0,
                                                     bytes(16384)):
        raise AssertionError("phase 12: the card's AES-256 keystream differs")
    log(f"phase 12 AES-256 keystream, 1,024 blocks on the card: {ks_s * 1e3:.2f}"
        " ms (warm), equal to the host's byte for byte")

    # (e) LimbField inv / mont_pow / mont_sqr over the chacha20 domain
    vals = [0, 1, host.R - 1] + [rnd.randrange(host.R) for _ in range(2**16 - 3)]
    e = rnd.randrange(1 << 64)
    a = Fr.to_device(vals, device="cuda")
    out = {}
    for name, fn, ref in (
            ("inv", Fr.inv, lambda v: pow(v, host.R - 2, host.R)),
            (f"mont_pow(e={e})", lambda x: Fr.mont_pow(x, e),
             lambda v: pow(v, e, host.R)),
            ("mont_sqr", Fr.mont_sqr, lambda v: v * v % host.R)):
        torch.cuda.synchronize()
        t = time.time()
        r = fn(a)
        torch.cuda.synchronize()
        out[name] = time.time() - t
        if Fr.from_device(r) != [ref(v) for v in vals]:
            raise AssertionError(f"phase 12: Fr.{name} differs from Python ints")
    log("phase 12 LimbField over 2^16 Fr elements on the card, equal to "
        "Python ints: " + ", ".join(f"{k} {v:.3f} s" for k, v in out.items()))

    # (f) trace_span around one warm proof
    trace_dir = os.path.join(HERE, "chiprun_out", "phase12_trace")
    os.environ["ZKSC_TRACE_DIR"] = trace_dir
    try:
        t = time.time()
        with trace_span("phase12_prove"):
            env2 = api.generate_proof("chacha20", key, ct, iv, device="cuda",
                                      rng=rng)
    finally:
        del os.environ["ZKSC_TRACE_DIR"]
    path = os.path.join(trace_dir, "phase12_prove.json")
    size = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    n_kernels = sum(1 for ev in events if ev.get("cat") == "kernel")
    if not api.verify_proof(env2, ct, iv, device="cuda") or n_kernels == 0:
        raise AssertionError("phase 12: the traced proof failed or the trace "
                             "holds no CUDA kernel")
    if size > 16 << 20:                       # keep the output directory small
        os.remove(path)
    log(f"phase 12 trace_span: {path} {size} B, {n_kernels} CUDA kernel "
        f"events, {len(events)} events ({time.time() - t:.2f} s with the "
        f"proof and the export){' (removed after reading)' if size > 16 << 20 else ''}")
    log(f"phase 12 total {time.time() - t0:.2f} s")
    return launches


# ------------------------------------------------------ phase 13: multi-device

MESH_SEED = 20245         # seed of phase 13's inputs and blinding
MESH_OUT = os.path.join(HERE, "zksc_tpu_torch", "build", "phase13_multihost")
MESH_NTT_LOG = 16         # the two-process NTT: the chacha20 domain


def mesh_requests(n: int) -> list:
    """n chacha20 requests (key, 128-byte ciphertext, iv) from MESH_SEED."""
    import random
    r = random.Random(MESH_SEED)
    return [{"key": bytes(r.randrange(256) for _ in range(32)),
             "ciphertext": bytes(r.randrange(256) for _ in range(128)),
             "iv": bytes(r.randrange(256) for _ in range(12))}
            for _ in range(n)]


def seeded_fr(n: int, device):
    import numpy as np

    from zksc_tpu_torch.fields.limb import Fr
    rs = np.random.RandomState(MESH_SEED + n)
    vals = [int(a) * int(b) % Fr.p for a, b in
            zip(rs.randint(1, 2**62, size=n), rs.randint(1, 2**62, size=n))]
    return Fr.to_device(vals, device=device)


def mesh_worker(argv) -> int:
    """One of phase 13's two processes (chip_smoke.py --mesh-worker PID
    PORT): joins a gloo group through parallel.multihost, runs the sharded
    NTT over the 4-shard global mesh (2 shards a process, both on the
    card; the exchanges at the widest span cross the process boundary,
    staged through the host) against the one-device transform, then
    proves its host_slice of the 4 chacha20 requests on the card and
    writes their envelopes to MESH_OUT/proofs_PID.json."""
    import torch

    from zksc_tpu_torch import api
    from zksc_tpu_torch.fields.limb import Fr
    from zksc_tpu_torch.ops.ntt import NTTContext
    from zksc_tpu_torch.ops.ntt_sharded import ShardedNTT
    from zksc_tpu_torch.parallel import multihost
    pid, port = int(argv[0]), argv[1]
    t = time.time()
    if not multihost.initialize(f"127.0.0.1:{port}", 2, pid):
        raise AssertionError("the process group did not start")
    backend = torch.distributed.get_backend()
    mesh = multihost.global_mesh(devices=["cuda", "cuda"])
    if mesh.size != 4 or mesh.local_shards != [2 * pid, 2 * pid + 1]:
        raise AssertionError(f"unexpected global mesh {mesh}")
    log(f"phase 13 worker {pid}: {backend} group, {mesh} "
        f"({time.time() - t:.2f} s)")
    n = 1 << MESH_NTT_LOG
    ntt = NTTContext(Fr, n, device="cuda")
    sntt = ShardedNTT(ntt, mesh)
    x = seeded_fr(n, "cuda")
    blocks = sntt.sharding.shard(x)
    for name in ("dif_inverse", "dit_forward", "coset_evals_from_coeffs_br",
                 "coeffs_br_from_coset_evals"):
        t = time.time()
        got = getattr(sntt, name)(blocks)
        torch.cuda.synchronize()
        secs = time.time() - t
        want = getattr(ntt, name)(x)
        for d in mesh.local_shards:
            if not torch.equal(got[d], want[:, d * sntt.C:(d + 1) * sntt.C]):
                raise AssertionError(f"worker {pid}: shard {d} of {name} "
                                     "differs from the one-device transform")
        log(f"phase 13 worker {pid}: two-process {name} 2^{MESH_NTT_LOG} "
            f"equal on shards {mesh.local_shards} ({secs * 1e3:.1f} ms)")
    reqs = mesh_requests(4)
    mine = multihost.host_slice(len(reqs))
    t = time.time()
    envs = api.generate_proofs("chacha20", reqs[mine], device="cuda")
    torch.cuda.synchronize()
    log(f"phase 13 worker {pid}: proved requests [{mine.start}, {mine.stop}) "
        f"in {time.time() - t:.2f} s (keys load + context + prove)")
    os.makedirs(MESH_OUT, exist_ok=True)
    with open(os.path.join(MESH_OUT, f"proofs_{pid}.json"), "w") as f:
        json.dump({"slice": [mine.start, mine.stop],
                   "envelopes": [e.to_json() for e in envs]}, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def run_two_processes(api) -> None:
    """Phase 13's two-process part: start both workers, wait for them
    (killing both on a failure or after 300 s), then verify all four
    proofs here and reject a flipped ciphertext byte."""
    import shutil
    import socket
    t = time.time()
    shutil.rmtree(MESH_OUT, ignore_errors=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("ZKSC_COORDINATOR", "ZKSC_NUM_PROCS", "ZKSC_PROC_ID")}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--mesh-worker", str(pid), str(port)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            print(f"    [worker {pid}] {line}", flush=True)
        if p.returncode != 0:
            raise AssertionError(f"phase 13 worker {pid} exited "
                                 f"{p.returncode}")
    from zksc_tpu_torch.api import ProofEnvelope
    reqs = mesh_requests(4)
    envs = [None] * len(reqs)
    for pid in range(2):
        with open(os.path.join(MESH_OUT, f"proofs_{pid}.json")) as f:
            rec = json.load(f)
        for i, e in zip(range(*rec["slice"]), rec["envelopes"]):
            envs[i] = ProofEnvelope.from_json(e)
    ok = [envs[i] is not None and api.verify_proof(
        envs[i], r["ciphertext"], r["iv"], device="cuda")
        for i, r in enumerate(reqs)]
    bad = bytes([reqs[0]["ciphertext"][0] ^ 1]) + reqs[0]["ciphertext"][1:]
    rejected = not api.verify_proof(envs[0], bad, reqs[0]["iv"],
                                    device="cuda")
    log(f"phase 13 two processes (gloo): {sum(ok)} of {len(reqs)} proofs "
        f"verified here, flipped ciphertext byte rejected {rejected} "
        f"({time.time() - t:.2f} s with both workers' start)")
    if not all(ok) or not rejected:
        raise AssertionError("phase 13: a two-process proof failed")


def run_tool(args: list, missing: str | None = None):
    """Run tools/<args[0]> as a subprocess and print its output. It must
    exit 0; or, given `missing` (a reference file this checkout lacks),
    exit non-zero with a message naming that file."""
    t = time.time()
    env = dict(os.environ)
    if missing is not None:
        env["ZKSC_REFERENCE_RESOURCES"] = os.path.join(
            HERE, "zksc_tpu_torch", "build", "phase13_no_reference")
        missing = os.path.join(env["ZKSC_REFERENCE_RESOURCES"], missing)
    out = subprocess.run([sys.executable, os.path.join(HERE, "tools", args[0]),
                          *args[1:]], capture_output=True, text=True,
                         timeout=600, cwd=HERE, env=env)
    text = out.stdout + out.stderr
    for line in text.splitlines():
        print(f"    [{args[0]}] {line}", flush=True)
    ok = out.returncode == 0 if missing is None else \
        out.returncode != 0 and missing in text
    log(f"phase 13 tool {' '.join(args)}: exit {out.returncode} "
        f"({time.time() - t:.2f} s){'' if ok else ' UNEXPECTED'}")
    if not ok:
        raise AssertionError(f"phase 13: tools/{args[0]} ended with "
                             f"{out.returncode}")


def drive_mesh(api, reset_counts, counts, rec) -> dict:
    """Phase 13. Returns the launch counts of the D = 4 chacha20 proof
    (K1, K2, K0, K4, K5) and of the D = 4 ladder proof (K3); `rec` logs the
    H calls of one more D = 4 proof for phase 5."""
    import random

    import torch

    from zksc_tpu_torch.curve import bn254_host as host
    from zksc_tpu_torch.fields.limb import Fr
    from zksc_tpu_torch.groth16 import ProverContext, setup, verify
    from zksc_tpu_torch.ops.ntt import NTTContext
    from zksc_tpu_torch.ops.ntt_sharded import ShardedNTT
    from zksc_tpu_torch.parallel.mesh import make_mesh
    from zksc_tpu_torch.r1cs import compile_circuit, generate_witness
    t0 = time.time()
    out = {}

    def blinding():
        r = random.Random(MESH_SEED)
        return lambda: r.randrange(1, host.R)

    def stages(timings):
        return " ".join(f"{k}={v:.3f}" for k, v in timings.items())

    # ---- the sharded chacha20 proof, D = 2 and 4 shards on the one card
    req = mesh_requests(1)[0]
    op = api.get_operator("chacha20", "groth16", "cuda")
    op._ensure_keys()
    one = op._ctx
    wi = api.generate_zk_witness("chacha20", req["key"], req["ciphertext"],
                                 req["iv"])
    wit = op.spec.build_witness(wi)
    pub = api.get_public_signals("chacha20", req["ciphertext"], req["iv"],
                                 wi.plaintext)
    bad_ct = bytes([req["ciphertext"][0] ^ 1]) + req["ciphertext"][1:]
    bad_pub = api.get_public_signals("chacha20", bad_ct, req["iv"],
                                     wi.plaintext)
    z_mont, _, _ = one._witnesses_to_device([wit])
    h1 = one.compute_h_batch(z_mont)
    p1 = one.prove(wit, rng=blinding())            # warm: phase 4 built it
    torch.cuda.synchronize()
    t = time.time()
    p1 = one.prove(wit, rng=blinding())
    torch.cuda.synchronize()
    one_s, one_stages = time.time() - t, dict(one.timings)
    log(f"phase 13 one-device chacha20 proof: {one_s:.3f} s "
        f"({stages(one_stages)})")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for D in (2, 4):
        t = time.time()
        ctx = ProverContext(one.cs, one.pk, device="cuda", mesh=make_mesh(D))
        hD = ctx.compute_h_batch(z_mont)
        if ctx._h_sharded is None or not torch.equal(hD, h1):
            raise AssertionError(f"phase 13: the D = {D} H limbs differ "
                                 "from the one-device limbs")
        _, n_h, dev_ms = h_pipeline_launches(ctx, z_mont)
        log(f"phase 13 sharded H at D = {D}: {n_h} kernel launches "
            f"(profiled host calls; cap {MESH_H_MAX_LAUNCHES}), device "
            f"{dev_ms:.2f} ms (profiled); limbs equal to one device")
        if n_h > MESH_H_MAX_LAUNCHES:
            raise AssertionError(f"phase 13: the D = {D} sharded H made "
                                 f"{n_h} launches, above "
                                 f"{MESH_H_MAX_LAUNCHES}")
        ctx.prove(wit, rng=blinding())             # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t1 = time.time()
        p = ctx.prove(wit, rng=blinding())
        torch.cuda.synchronize()
        secs = time.time() - t1
        launches = counts()
        same = (p.a, p.b, p.c) == (p1.a, p1.b, p1.c)
        ok = op.verify(pub, p.to_json_dict())
        rejected = not op.verify(bad_pub, p.to_json_dict())
        log(f"phase 13 chacha20 on a mesh of {D} shards (one card: the "
            f"shards run one after another, so this is the layer's "
            f"overhead, not a speed-up): H limbs equal, proof {secs:.3f} s "
            f"({stages(ctx.timings)}) beside one device {one_s:.3f} s "
            f"({stages(one_stages)}); equal to the one-device proof {same}, "
            f"verify {ok}, flipped ciphertext byte rejected {rejected}; "
            f"launches {launches} ({time.time() - t:.2f} s with the context)")
        if not (same and ok and rejected):
            raise AssertionError(f"phase 13: the D = {D} proof failed")
        for k in ("chunk_scan", "jac_add_n") + H_NAMES + GLUE_NAMES:
            if launches[k] <= 0:
                raise AssertionError(f"phase 13: {k} not launched at D = {D}")
        out["chacha20"] = launches
    with rec:                                      # phase 5's mesh calls
        rec.window = True
        ctx.prove(wit, rng=blinding())
        rec.window = False
    rec.calls, rec.log = {}, []                    # K1-K3 replay elsewhere
    log(f"phase 13 peak device memory of the mesh proofs "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
        f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.3f} GiB "
        f"above the {held / 2**30:.3f} GiB that earlier phases hold")
    del ctx

    # ---- the sharded NTT, D = 8, against NTTContext
    for log_n in (16, 18):
        t = time.time()
        ntt = one.ntt if log_n == 16 else NTTContext(Fr, 1 << log_n,
                                                     device="cuda")
        sntt = ShardedNTT(ntt, make_mesh(8))
        x = seeded_fr(1 << log_n, "cuda")
        blocks = sntt.sharding.shard(x)
        times = []
        for name in ("dif_inverse", "dit_forward",
                     "coset_evals_from_coeffs_br",
                     "coeffs_br_from_coset_evals", "coset_evals_from_evals",
                     "coeffs_br_from_coset_evals from_mont"):
            kw = {"from_mont": True} if name.endswith("from_mont") else {}
            fn_name = name.split()[0]
            ms = []
            for fn in (lambda: getattr(ntt, fn_name)(x, **kw),
                       lambda: sntt.sharding.gather(
                           getattr(sntt, fn_name)(blocks, **kw))):
                fn()
                torch.cuda.synchronize()
                t1 = time.time()
                r = fn()
                torch.cuda.synchronize()
                ms.append(((time.time() - t1) * 1e3, r))
            if not torch.equal(ms[0][1], ms[1][1]):
                raise AssertionError(f"phase 13: sharded {name} 2^{log_n} "
                                     "differs from NTTContext")
            times.append(f"{name} {ms[0][0]:.2f} / {ms[1][0]:.2f} ms")
        log(f"phase 13 ShardedNTT 2^{log_n}, D = 8, equal to NTTContext "
            f"(one device / sharded, host clock): {'; '.join(times)} "
            f"({time.time() - t:.2f} s with the tables)")

    # ---- the ladder branch on a D = 4 mesh: the x^100 circuit of phase 7
    t = time.time()
    define = _power_circuit(99, False)
    pub_l, priv_l = [("out", 1)], [("x", 1)]
    cs = compile_circuit(define, pub_l, priv_l)
    srng = random.Random(23)
    pk, vk = setup(cs, rng=lambda: srng.randrange(2, host.R), device="cuda")
    x = 7
    o = (pow(x, 100, host.R) + x + 41) % host.R
    wl = generate_witness(define, pub_l, priv_l, {"out": [[o]]},
                          {"x": [[x]]}, batch=1)[:, 0]
    lad1 = ProverContext(cs, pk, device="cuda").prove(wl, rng=blinding())
    ctx4 = ProverContext(cs, pk, device="cuda", mesh=make_mesh(4))
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.time()
    lad4 = ctx4.prove(wl, rng=blinding())
    torch.cuda.synchronize()
    secs = time.time() - t1
    launches = counts()
    same = (lad4.a, lad4.b, lad4.c) == (lad1.a, lad1.b, lad1.c)
    ok = verify(vk, lad4, [o]) and not verify(vk, lad4, [(o + 1) % host.R])
    log(f"phase 13 ladder branch (x^100, m_pad {ctx4.m_pad}) on a mesh of 4: "
        f"proof {secs:.3f} s, equal to the one-device proof {same}, verify "
        f"and tamper {ok}; launches {launches} ({time.time() - t:.2f} s "
        f"with setup)")
    if not (same and ok) or launches["ladder"] <= 0:
        raise AssertionError("phase 13: the ladder-branch mesh proof failed")
    out["ladder"] = launches

    # ---- two processes under multihost.initialize (gloo)
    run_two_processes(api)

    # ---- the tools
    run_tool(["profile_prove_torch.py", "2"])
    run_tool(["bench_stark_torch.py", "--chacha-logs", "6", "--aes-blocks",
              "64", "--repeat", "1"])
    run_tool(["gen_oneblock_artifacts_torch.py"])
    prove_one_block(api)
    run_tool(["run_imported_r1cs_e2e_torch.py"],
             missing=os.path.join("gnark", "r1cs.chacha20"))
    run_tool(["stwo_crosscheck_torch.py"],
             missing=os.path.join("stwo", "s2circuits_bg.wasm"))
    log(f"phase 13 total {time.time() - t0:.2f} s")
    return out


BATCH_SEED = 2026         # phase 14's requests and blinding
# the H pass's launch calls, at most (K0, K4, K5 and the glue around them)
H_MAX_LAUNCHES = 200
# the sharded H's launch calls at D = 2 and 4, at most: at D = 4 one K0
# pack, 4 K5, 8 + 8 + 8 K0 cross stages, 12 + 8 K4 and 4 K0 quotients,
# one gather; the eager Fr ops it replaces made thousands
MESH_H_MAX_LAUNCHES = 150


def h_pipeline_launches(ctx, z_mont):
    """One compute_h_batch under torch.profiler (CUDA activity alone): (h,
    kernel launches, device ms), read from the raw trace events (building
    key_averages' event tree for ~40K launches takes tens of seconds). The
    launches are the host's launch calls: at AES's sizes the card's own
    kernel records come back a few dozen to a few hundred short in some
    runs, so they give the device ms alone. Raises when the profiler sees
    no launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h = ctx.compute_h_batch(z_mont)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    n = sum(1 for e in events
            if e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    if n == 0:
        raise AssertionError("phase 14: the profiler saw no kernel launch")
    dev_ms = sum(e.duration_ns() for e in events
                 if e.device_type() == DeviceType.CUDA) / 1e6
    return h, n, dev_ms


def drive_batch(api, reset_counts, counts, recs) -> dict:
    """Phase 14: api.generate_proofs at k = 1, 2, 4 (chacha20, the
    committed key) and k = 4 (aes-128-ctr, phase 6's contributed key), k
    consecutive chunks of one stream. Each k proves first at this k, then
    warm (launch counters reset just before each, K1 and K2 > 0; stage
    seconds, peak device memory above what was held before), k = 4 once
    more under recs[alg], which logs its kernel calls for phase 5; every
    proof of the warm batch verifies and rejects a flipped ciphertext
    byte. compute_h_batch at each k (and k = 1 for AES) equals the
    per-proof _h_core limb for limb, and its kernel launches
    (torch.profiler) at k = 4 are at most 1.01x those at k = 1. Returns the
    K1 / K2 launches of each warm k = 4 batch."""
    import random
    t0 = time.time()
    rnd = random.Random(BATCH_SEED)
    blind = random.Random(BATCH_SEED + 1)
    rng = lambda: blind.randrange(1, 1 << 250)
    out = {}
    for alg, key_len, chunk, ks in (("chacha20", 32, 128, (1, 2, 4)),
                                    ("aes-128-ctr", 16, 80, (4,))):
        key = bytes(rnd.randrange(256) for _ in range(key_len))
        iv = bytes(rnd.randrange(256) for _ in range(12))
        reqs = [{"key": key, "iv": iv, "offset_bytes": j * chunk,
                 "ciphertext": bytes(rnd.randrange(256) for _ in range(chunk))}
                for j in range(max(ks))]
        op = api.get_operator(alg, "groth16", "cuda")
        out[alg] = prove_batches(api, alg, op, reqs, ks, rng, recs[alg],
                                 reset_counts, counts)
        h_batches(api, alg, op, reqs, ks)
    log(f"phase 14 total {time.time() - t0:.2f} s")
    return out


def prove_batches(api, alg, op, reqs, ks, rng, rec, reset_counts,
                  counts) -> dict:
    """Phase 14's proofs of one statement: each k first and warm, and k = 4
    once more with `rec` logging its kernel calls (its seconds and memory
    include the recorder's). Returns the warm k = 4 batch's K1 / K2
    launches."""
    import torch
    for k in ks:
        for run in ("first", "warm") + (("recorded",) if k == 4 else ()):
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t = time.time()
            if run == "recorded":
                with rec:
                    rec.window = True
                    api.generate_proofs(alg, reqs[:k], device="cuda", rng=rng)
                    rec.window = False
            else:
                envs = api.generate_proofs(alg, reqs[:k], device="cuda",
                                           rng=rng)
            torch.cuda.synchronize()
            prove_s = time.time() - t
            peak = torch.cuda.max_memory_allocated() - held
            stages = " ".join(f"{n}={v:.3f}" for n, v in op.timings.items())
            log(f"phase 14 {alg} k={k} {run}: {prove_s:.3f} s "
                f"({prove_s / k:.3f} s a proof; {stages}); launches "
                f"{counts()}; peak device memory {peak / 2**30:.3f} GiB above "
                f"the {held / 2**30:.3f} GiB held before")
            if run == "warm":
                launches = counts()
        for name in ("chunk_scan", "jac_add_n") + H_NAMES + GLUE_NAMES:
            if launches[name] <= 0:
                raise AssertionError(f"phase 14: {name} was not launched by "
                                     f"the {alg} batch of {k}")
        t = time.time()
        for env, r in zip(envs, reqs):
            ct, off = r["ciphertext"], r["offset_bytes"]
            if not api.verify_proof(env, ct, r["iv"], off, device="cuda"):
                raise AssertionError(f"phase 14: an {alg} proof of the batch "
                                     f"of {k} did not verify")
            bad = ct[:3] + bytes([ct[3] ^ 4]) + ct[4:]
            if api.verify_proof(env, bad, r["iv"], off, device="cuda"):
                raise AssertionError(f"phase 14: a tampered {alg} ciphertext "
                                     "verified")
        log(f"phase 14 {alg} k={k}: {k} proofs verify, {k} tampered "
            f"ciphertexts rejected ({time.time() - t:.2f} s)")
    return {n: launches[n] for n in ("chunk_scan", "jac_add_n") + H_NAMES
            + GLUE_NAMES}


def h_batches(api, alg, op, reqs, ks):
    """Phase 14's H pipeline of one statement at each k and at k = 1: equal
    to the per-proof _h_core, and at k = 4 at most 1.01x k = 1's CUDA
    launches."""
    import torch
    ctx = op._ctx
    h_launches = {}
    for k in sorted(set(ks) | {1}):
        wis = [api.generate_zk_witness(alg, r["key"], r["ciphertext"],
                                       r["iv"], r["offset_bytes"])
               for r in reqs[:k]]
        z_mont, _, _ = ctx._witnesses_to_device(
            [op.spec.build_witness(wi) for wi in wis])
        h, n, dev_ms = h_pipeline_launches(ctx, z_mont)
        one = torch.stack([ctx._h_core(z_mont[:, j]) for j in range(k)],
                          dim=1)
        if not torch.equal(h, one):
            raise AssertionError(f"phase 14: the batched {alg} h of {k} "
                                 "proofs differs from the per-proof h")
        h_launches[k] = n
        log(f"phase 14 {alg} H pipeline k={k}: {n} kernel launches, device "
            f"{dev_ms:.2f} ms (profiled); equal to the per-proof h")
        if n > H_MAX_LAUNCHES:
            raise AssertionError(f"phase 14: the {alg} H pass at k={k} made "
                                 f"{n} launches, above {H_MAX_LAUNCHES}")
    ratio = h_launches[4] / h_launches[1]
    log(f"phase 14 {alg} H pipeline launches k=4 / k=1: {ratio:.4f}")
    if ratio > 1.01:
        raise AssertionError(f"phase 14: the {alg} H pipeline launches "
                             f"{ratio:.4f}x as much at k=4 as at k=1")


def prove_one_block(api):
    """One proof with the key gen_oneblock_artifacts_torch.py wrote: the
    1-block chacha20 circuit, verified, a flipped public bit rejected."""
    import random

    import torch

    from zksc_tpu_torch.groth16 import ProverContext, verify
    from zksc_tpu_torch.groth16 import artifacts as art
    from zksc_tpu_torch.ops.ciphers import chacha20_encrypt
    from zksc_tpu_torch.r1cs import compile_circuit, generate_witness
    from zksc_tpu_torch.r1cs.circuits import chacha20 as cc
    t = time.time()
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from gen_oneblock_artifacts_torch import OUT_DIR
    cs = compile_circuit(cc.make_define(1), cc.public_layout(1),
                         cc.private_layout(1))
    pk, vk = art.load_keys(OUT_DIR, expected_digest=cs.digest(),
                           device="cuda")
    r = random.Random(MESH_SEED + 1)
    key = bytes(r.randrange(256) for _ in range(32))
    iv = bytes(r.randrange(256) for _ in range(12))
    ct = bytes(r.randrange(256) for _ in range(64))
    pt = chacha20_encrypt(key, iv, 1, ct)
    pub, priv = cc.witness_inputs([key], [[(iv, 1)]], [[ct]], [[pt]], 1)
    w = generate_witness(cc.make_define(1), cc.public_layout(1),
                         cc.private_layout(1), pub, priv, batch=1)
    t1 = time.time()
    proof = ProverContext(cs, pk, device="cuda").prove(w[:, 0])
    torch.cuda.synchronize()
    secs = time.time() - t1
    pub_vals = [int(v) for v in w[1:1 + cs.n_public, 0]]
    bad = list(pub_vals)
    bad[0] ^= 1
    ok, rejected = verify(vk, proof, pub_vals), not verify(vk, proof, bad)
    log(f"phase 13 1-block chacha20 ({cs.n_constraints} constraints, domain "
        f"{pk.domain_n}) with the tool's key: proof {secs:.3f} s (context "
        f"+ prove), verify {ok}, tampered bit rejected {rejected} "
        f"({time.time() - t:.2f} s with compile and load)")
    if not (ok and rejected):
        raise AssertionError("phase 13: the 1-block proof failed")


# ------------------------------------------------ the Groth16 H kernels

H_SEED = 20246            # phase 3's H-kernel inputs
H_NAMES = ("fr_elementwise", "ntt_group", "sparse_matvec")
H_SRC = "zksc_tpu_torch/csrc/h_kernels.cu"
# what each H kernel replaces in the JAX package (XLA-fused jnp there)
H_REPLACES = {
    "fr_elementwise": "zksc_tpu/groth16/prove.py:413 _h_core (Fr.mont_mul "
                      "/ Fr.sub of the quotient) and :440 Fr.to_mont",
    "ntt_group": "zksc_tpu/ops/ntt.py:107 dif_inverse, :125 dit_forward, "
                 ":141 coset_evals_from_coeffs_br, :147 "
                 "coeffs_br_from_coset_evals",
    "sparse_matvec": "zksc_tpu/groth16/prove.py:183 _matvec"}
# NTTContext._transform's (dif, dit, scale) -> the transform it computes
NTT_FORMS = {(True, False, "ninv"): "dif_inverse",
             (False, True, None): "dit_forward",
             (False, True, "shift"): "coset_evals_from_coeffs_br",
             (True, False, "ninv_shift_inv"): "coeffs_br_from_coset_evals",
             (True, False, "ninv_shift_inv_plain"):
                 "coeffs_br_from_coset_evals from_mont",
             (True, True, "ninv_shift"): "coset_evals_from_evals"}
# the boundary's bytes per Fr element: 16 int32 limbs
FR_BYTES = 64


def h_variant(attr, args):
    """((kernel, variant), the tensor that sizes it) of a recorded H call."""
    if attr == "_transform":
        ctx, x, dif, dit, scale = args
        return ("ntt_group", NTT_FORMS[(dif, dit, scale)]), x
    if attr == "_local_block":
        sntt, d, x, dif, dit, scale = args
        return ("ntt_group", "mesh block " + NTT_FORMS[(dif, dit, scale)]), x
    if attr == "sparse_matvec":
        return ("sparse_matvec", "A, B, C stacked"), args[0]
    if attr == "pack_z":
        return ("fr_elementwise", "pack"), args[0]
    if attr == "cross_stage":
        x, _, _, _, _, dif, v_half = args
        return ("fr_elementwise", f"cross {'dif' if dif else 'dit'} "
                                  f"{'v' if v_half else 'u'}"), x
    return ("fr_elementwise", attr), args[0]


def h_fns(key, args):
    """(kernel call, plain call) of a recorded H call."""
    from zksc_tpu_torch.fields.limb import Fr
    from zksc_tpu_torch.ops import h_kernels
    name, variant = key
    if name == "ntt_group" and variant.startswith("mesh block"):
        sntt, d, x, dif, dit, scale = args
        return (lambda: sntt._local_block(d, x, dif, dit, scale),
                lambda: sntt._local_plain(d, x, dif, dit, scale))
    if name == "ntt_group":
        ctx, x, dif, dit, scale = args
        return (lambda: ctx._transform(x, dif, dit, scale),
                lambda: ctx._transform_plain(x, dif, dit, scale))
    if name == "sparse_matvec":
        return (lambda: h_kernels.sparse_matvec(*args),
                lambda: h_kernels.sparse_matvec_plain(*args))
    if variant == "to_mont":
        return (lambda: h_kernels.to_mont(args[0]),
                lambda: Fr.to_mont(args[0]))
    if variant == "pack":
        return (lambda: h_kernels.pack_z(args[0]),
                lambda: h_kernels.pack_z_plain(args[0]))
    if variant.startswith("cross"):
        return (lambda: h_kernels.cross_stage(*args),
                lambda: h_kernels.cross_stage_plain(*args))
    return (lambda: h_kernels.quotient(*args),
            lambda: h_kernels.quotient_plain(*args))


def k5_kinds(csr) -> list:
    """The number of K5 terms of each kind (h_kernels.TERM_*): +1, -1, +c,
    -c (c < 2^32), wide."""
    import torch
    from zksc_tpu_torch.ops import h_kernels
    kinds = (csr.terms[:, 0].long() & 0xFFFFFFFF) >> h_kernels.TERM_KIND_SHIFT
    return torch.bincount(kinds, minlength=5).tolist()


def h_shape(key, args) -> str:
    name, variant = key
    if name == "sparse_matvec":
        z, csr = args
        return (f"k={z.shape[0]} m_pad={z.shape[1]} n={csr.n} "
                f"nnz={csr.cols.numel()} bins={list(csr.bins)} "
                f"kinds={k5_kinds(csr)}")
    if name == "ntt_group":
        x = args[2] if variant.startswith("mesh block") else args[1]
    else:
        x = args[0]
    return "x".join(str(d) for d in x.shape)


def k5_bound_per_term_ms(args, imad_rate):
    """K5's bound with one Fr product a term, against the bytes
    of the limb-major z (64 B an element), a 32-byte coefficient and a
    4-byte column a term, the row pointers and the output."""
    z, csr = args
    k, m_pad = z.shape[0], z.shape[1]
    nnz = csr.cols.numel()
    ops_ms = k * nnz * IMAD_PER_FP_MUL / imad_rate * 1e3
    nbytes = (FR_BYTES * k * m_pad + 36 * nnz + 4 * (csr.M * csr.n + 1)
              + FR_BYTES * csr.M * k * csr.n)
    return max(ops_ms, nbytes / HBM_BYTES_PER_S * 1e3)


def h_bound_ms(key, args, imad_rate):
    """(bound ms, bound_by, Fr products) of one H call: the products
    (IMAD_PER_FP_MUL each; adds, subs and K5's 256 x 32-bit products not
    counted) over the card's IMAD rate against the bytes over HBM: each
    input read once (the boundary's 64 B an element, 32 B a packed table
    entry, wide coefficient or element of K5's packed z, 8 B a K5 term, 4 B
    a row pointer or bin row), each output written once. K5 counts the
    work its coefficient classes need: a product only for a wide
    coefficient's term (k5_bound_per_term_ms counts one a term)."""
    name, variant = key
    if name == "ntt_group":
        if variant.startswith("mesh block"):
            sntt, _, x, dif, dit, scale = args
            ctx = sntt.ntt
        else:
            ctx, x, dif, dit, scale = args
        n = x.shape[-1]
        rows = x.numel() // (16 * n)
        log_n = n.bit_length() - 1
        prods = rows * (n // 2) * log_n * (int(dif) + int(dit))
        nbytes = 2 * FR_BYTES * rows * n + 32 * (n // 2) * (int(dif) + int(dit))
        if scale is not None:
            width = min(ctx._scales[scale].shape[-1], n)
            prods += rows * n
            nbytes += 32 * width
    elif name == "sparse_matvec":
        z, csr = args
        k, m_pad = z.shape[0], z.shape[1]
        n_wide = k5_kinds(csr)[4]
        prods = k * n_wide
        nbytes = (32 * k * m_pad + 8 * csr.cols.numel() + 32 * n_wide
                  + 4 * (2 * csr.M * csr.n + 1) + FR_BYTES * csr.M * k * csr.n)
    elif variant == "to_mont":
        N = args[0].numel() // 16
        prods, nbytes = N, 2 * FR_BYTES * N
    elif variant == "pack":
        N = args[0].numel() // 16
        prods, nbytes = 0, (FR_BYTES + 32) * N
    elif variant.startswith("cross"):
        x = args[0]
        N, C = x.numel() // 16, x.shape[-1]
        prods = 0 if variant == "cross dif u" else N
        nbytes = 3 * FR_BYTES * N + (0 if prods == 0 else 32 * C)
    else:
        N = args[0].numel() // 48
        prods, nbytes = 2 * N, 4 * FR_BYTES * N
    ops_ms = prods * IMAD_PER_FP_MUL / imad_rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes"), prods


def fr_random(shape, device, gen):
    """Canonical Fr limbs [16, *shape] on the device: uniform 16-bit limbs,
    the top one below r's (0x3064), and 0, 1, r - 1 as the first three
    elements."""
    import torch
    from zksc_tpu_torch.fields.limb import Fr
    x = torch.randint(0, 1 << 16, (Fr.L, *shape), generator=gen,
                      dtype=torch.int32, device=device)
    x[Fr.L - 1] %= 0x3064
    flat = x.view(Fr.L, -1)
    k = min(3, flat.shape[1])
    flat[:, :k] = Fr.to_device([0, 1, Fr.p - 1], mont=False,
                               device=device)[:, :k]
    return x


def class_coeffs(count: int, rng, device, gen):
    """Montgomery coefficients [16, count] of K5's classes, a third each:
    +-1, +-c with c < 2^32, and wide (random residues)."""
    import numpy as np
    import torch
    from zksc_tpu_torch.fields.limb import Fr
    kind = rng.integers(0, 3, count)
    c = rng.integers(2, 1 << 32, count, dtype=np.int64)
    c[kind == 0] = 1
    plain = torch.zeros((Fr.L, count), dtype=torch.int32, device=device)
    cc = torch.as_tensor(c, device=device)
    plain[0], plain[1] = (cc & 0xFFFF).to(torch.int32), (cc >> 16).to(torch.int32)
    neg = torch.as_tensor(rng.random(count) < 0.5, device=device)
    plain[:, neg] = Fr.neg(plain[:, neg])
    wide = torch.as_tensor(kind == 2, device=device)
    plain[:, wide] = fr_random((int(wide.sum()),), device, gen)
    return Fr.to_mont(plain)


def random_csr(n: int, m_pad: int, rate: float, long_rows: int, rng,
               device, block_rows: int = 2):
    """Three stacked random matrices of n rows over m_pad columns: a
    Poisson(rate) number of terms a row, every 7th row empty, `long_rows`
    rows of 300 terms (K5's warp bin) and `block_rows` of 1,500 (its block
    bin); coefficients of every class (class_coeffs)."""
    import numpy as np
    import torch
    from zksc_tpu_torch.ops import h_kernels
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))
    mats = []
    for _ in range(3):
        counts = rng.poisson(rate, n)
        counts[::7] = 0
        counts[rng.integers(0, n, long_rows)] = 300
        counts[rng.integers(0, n, block_rows)] = 1500
        rows = np.repeat(np.arange(n), counts)
        cols = rng.integers(0, m_pad, rows.size)
        mats.append((torch.as_tensor(rows, device=device),
                     torch.as_tensor(cols, device=device),
                     class_coeffs(rows.size, rng, device, gen)))
    return h_kernels.CSR.stack(mats, n)


def check_h_kernels(device, imad_rate):
    """Phase 3: K0, K4, K5 against their plain versions, limb for limb. At
    check sizes: K0 over 8,191 and 3 x 8,191 elements (a ragged last
    block), its pack of z and both halves of both cross stages; K4 every
    transform form at 2^8 and 2^10 with a 2^4 tile (two and three launches
    a direction) and at 2^11 with the largest tile (one group); K5 over
    1,000 rows (empty rows, warp and block rows, every coefficient class,
    a ragged block). At the paths' shapes, n = 2^16, 2^17, 2^18 with k = 1
    and 4: to_mont of [16, k, n], the quotient over [16, 3, k, n], the
    coset transform over [16, 3k, n] and the way back (from_mont) over
    [16, k, n] in the tiles picked from the grid, K5 over a random CSR of
    3 x n rows (0.43 terms a row on average, 8 rows of 300 and 2 of
    1,500; the circuits' own matrices, 0.9-7.3 terms a row, are phase
    5's). Each line: the kernel's ms (CUDA events), the plain version's,
    the bound (K5: both forms)."""
    import numpy as np
    import torch
    from zksc_tpu_torch.fields.limb import Fr
    from zksc_tpu_torch.ops import h_kernels
    from zksc_tpu_torch.ops.ntt import NTTContext
    rng = np.random.default_rng(H_SEED)
    gen = torch.Generator(device=device).manual_seed(H_SEED)
    err = 0

    def check(label, key, args, run=None, plain=None):
        nonlocal err
        k_run, k_plain = h_fns(key, args)
        ms, plain_ms, e = compare(label, run or k_run, plain or k_plain,
                                  lambda r: [r])
        bound, by, prods = h_bound_ms(key, args, imad_rate)
        per_term = (f", a product a term {k5_bound_per_term_ms(args, imad_rate):.4f} ms"
                    if key[0] == "sparse_matvec" else "")
        log(f"phase 3 {label}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
            f"bound {bound:.4f} ms ({by}, {prods} Fr products{per_term}), "
            f"max_abs_err={e}")
        err = max(err, e)

    t0 = time.time()
    x = fr_random((8191,), device, gen)
    check("K0 to_mont N=8191", ("fr_elementwise", "to_mont"), (x,))
    abc = fr_random((3, 8191), device, gen)
    check("K0 quotient N=8191", ("fr_elementwise", "quotient"), (abc, 12345))
    check("K0 pack [16, 2, 4095]", ("fr_elementwise", "pack"),
          (fr_random((2, 4095), device, gen),))
    tw_inv, tw_fwd, _ = NTTContext(Fr, 1 << 14, device=device)._kernel_tables()
    x, other = fr_random((8191,), device, gen), fr_random((8191,), device, gen)
    for dif in (True, False):
        for v_half in (False, True):
            args = (x, other, tw_inv if dif else tw_fwd, 1, 1, dif, v_half)
            check(f"K0 cross {'dif' if dif else 'dit'} "
                  f"{'v' if v_half else 'u'} N=8191", h_variant(
                      "cross_stage", args)[0], args)
    for log_n, log_tile in ((8, 4), (10, 4), (11, 11)):
        ctx = NTTContext(Fr, 1 << log_n, device=device)
        tw_inv, tw_fwd, words = ctx._kernel_tables()
        x = fr_random((3, 1 << log_n), device, gen)
        groups = len(h_kernels.ntt_plan(log_n, log_tile))
        for (dif, dit, scale), form in NTT_FORMS.items():
            run = lambda: h_kernels.ntt(x, tw_inv, tw_fwd, dif, dit,
                                        None if scale is None else words[scale],
                                        log_tile)
            check(f"K4 {form} [16, 3, 2^{log_n}] tile 2^{log_tile} "
                  f"({groups} groups)", ("ntt_group", form),
                  (ctx, x, dif, dit, scale), run=run)
    csr = random_csr(1000, 300, 1.3, 3, rng, device)
    z = h_kernels.pack_z(fr_random((2, 300), device, gen))
    check(f"K5 n=1000 k=2 (empty, 300- and 1,500-term rows; bins "
          f"{list(csr.bins)}, kinds {k5_kinds(csr)})",
          ("sparse_matvec", "A, B, C stacked"), (z, csr))
    for log_n in (16, 17, 18):
        n = 1 << log_n
        ctx = NTTContext(Fr, n, device=device)
        csr = random_csr(n, n, 1.3 / 3, 8, rng, device)
        for k in (1, 4):
            z = fr_random((k, n), device, gen)
            check(f"K0 to_mont [16, {k}, 2^{log_n}]",
                  ("fr_elementwise", "to_mont"), (z,))
            check(f"K5 k={k} n=2^{log_n} nnz={csr.cols.numel()}",
                  ("sparse_matvec", "A, B, C stacked"),
                  (h_kernels.pack_z(z), csr))
            abc = fr_random((3 * k, n), device, gen)
            check(f"K4 coset_evals_from_evals [16, {3 * k}, 2^{log_n}] "
                  f"tile 2^{h_kernels.pick_log_tile(log_n, 3 * k)}",
                  ("ntt_group", "coset_evals_from_evals"),
                  (ctx, abc, True, True, "ninv_shift"))
            check(f"K0 quotient [16, 3, {k}, 2^{log_n}]",
                  ("fr_elementwise", "quotient"),
                  (abc.view(16, 3, k, n), ctx.z_coset_int))
            h = abc[:, :k].contiguous()
            check(f"K4 coeffs_br_from_coset_evals from_mont [16, {k}, "
                  f"2^{log_n}] tile 2^{h_kernels.pick_log_tile(log_n, k)}",
                  ("ntt_group", "coeffs_br_from_coset_evals from_mont"),
                  (ctx, h, True, False, "ninv_shift_inv_plain"))
        del ctx, csr
    log(f"phase 3 H kernels checked ({time.time() - t0:.2f} s, "
        f"max_abs_err {err})")
    return err


def time_h_kernels(calls, imad_rate, path: str):
    """Phase 5: each H kernel variant's largest call of one path replayed
    through the kernel and its plain version (equal limb for limb), timed
    (card-only and host-paced CUDA events) beside its bound."""
    rows = []
    for key in sorted(calls, key=str):
        args, _ = calls[key]
        run, plain = h_fns(key, args)
        shape = h_shape(key, args)
        ms, plain_ms, err = compare(f"{key[0]} {key[1]} {shape}", run, plain,
                                    lambda r: [r])
        paced = cuda_ms(run, reps=3, paced=True)
        bound, by, prods = h_bound_ms(key, args, imad_rate)
        row = {"name": key[0], "path": path, "variant": key[1],
               "shape": shape, "ms": ms, "paced_ms": paced,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "ops_needed": prods, "max_abs_err": err}
        per_term = ""
        if key[0] == "sparse_matvec":
            row["bound_ms_product_a_term"] = k5_bound_per_term_ms(args,
                                                                  imad_rate)
            per_term = (f"; a product a term "
                        f"{row['bound_ms_product_a_term']:.4f} ms")
        log(f"[{path}] {key[0]} {key[1]} {shape}: kernel {ms:.4f} ms "
            f"({paced:.4f} ms paced by the host), plain {plain_ms:.2f} ms, "
            f"bound {bound:.4f} ms ({by}, {prods} Fr products{per_term}), "
            f"max_abs_err={err}")
        rows.append(row)
    return rows


def h_proof_totals(log_calls, imad_rate, path: str, counts, reset_counts):
    """Phase 5: every H kernel call of one warm proof (or batch), in order,
    replayed through the kernel: per kernel the launches, the summed ms and
    the summed bound."""
    tot = {}
    for key, args in log_calls:
        run, _ = h_fns(key, args)
        reset_counts()
        run()
        n_launch = counts()[key[0]]
        ms = cuda_ms(run, reps=2)
        paced = cuda_ms(run, reps=2, paced=True)
        bound, _, prods = h_bound_ms(key, args, imad_rate)
        t = tot.setdefault(key[0], {"launches": 0, "ms": 0.0, "paced_ms": 0.0,
                                    "bound_ms": 0.0, "ops_needed": 0})
        if key[0] == "sparse_matvec":
            t["bound_ms_product_a_term"] = t.get("bound_ms_product_a_term",
                                                 0.0) + k5_bound_per_term_ms(
                                                     args, imad_rate)
        t["launches"] += n_launch
        t["ms"] += ms
        t["paced_ms"] += paced
        t["bound_ms"] += bound
        t["ops_needed"] += prods
    for name, t in sorted(tot.items()):
        log(f"[{path} warm proof] {name}: {t['launches']} launches, kernel "
            f"{t['ms']:.4f} ms in all ({t['paced_ms']:.4f} ms paced by the "
            f"host), bound {t['bound_ms']:.4f} ms "
            f"({100 * t['bound_ms'] / max(t['ms'], 1e-9):.1f}% of the time"
            + (f"; a product a term {t['bound_ms_product_a_term']:.4f} ms"
               if "bound_ms_product_a_term" in t else "")
            + f"), {t['ops_needed']} Fr products")
    return tot


def h_kernel_entries(rows, per_proof, launches, batch_launches,
                     mesh_launches, err):
    """The K0 / K4 / K5 entries of the kernels line: each kernel's largest
    call of phase 4's warm chacha20 proof, with its launches there, its
    launches in phase 13's D = 4 mesh proof and phase 14's batches, and
    the per-proof totals of every recorded path."""
    entries = []
    for name in H_NAMES:
        mine = [r for r in rows if r["name"] == name]
        main = max((r for r in mine if r["path"] == "chacha20"),
                   key=lambda r: r["bound_ms"])
        entries.append({
            "name": name, "route": "cuda", "source": H_SRC,
            "replaces": H_REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "path": "chacha20",
            "shape": f"{main['variant']} {main['shape']}",
            "launches_batch4": {a: n[name] for a, n in batch_launches.items()},
            "launches_mesh4": mesh_launches[name],
            "per_proof": {p: t[name] for p, t in per_proof.items()
                          if name in t},
            "variants": mine})
        if name == "sparse_matvec":
            entries[-1]["bound_ms_product_a_term"] = \
                main["bound_ms_product_a_term"]
    return entries


def time_stark_kernels(log_calls, imad_rate, path: str, key_size=None,
                       groups=None):
    """Phase 5 for K7: the largest call of each K7 instance in one warm
    proof, replayed through the kernel (card-only and host-paced CUDA-event
    times) and its plain version (equal value for value), beside its
    bound; then every call of the proof replayed in order, summed per
    kernel. key_size: the AES AIR's, for K7d; groups: K7c's index groups
    (default the stark engine's chacha20 AIR). Returns (rows, totals)."""
    from zksc_tpu_torch.ops import stark_kernels
    largest = {}
    for name, args in log_calls:
        key = (name, k7_variant(name, args))
        size = args[0].numel() * (args[2] if name.startswith("blake2s") else 1)
        if key not in largest or size > largest[key][0]:
            largest[key] = (size, args)
    rows = []
    for (name, variant), (_, args) in sorted(largest.items()):
        kern = getattr(stark_kernels, name)
        run = lambda: kern(*args)
        ms, plain_ms, err = compare(f"{name} {variant}", run,
                                    lambda: k7_plain(name, args, key_size,
                                                     groups),
                                    lambda r: [r])
        paced = cuda_ms(run, reps=3, paced=True)
        bound, by, work = k7_bound_ms(name, args, imad_rate)
        row = {"name": name, "path": path, "variant": variant,
               "ms": ms, "paced_ms": paced, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by, "max_abs_err": err}
        chain = ""
        if name.startswith("blake2s"):
            floor, comp = k7a_chain_ms(name, args, imad_rate)
            chain = (f", chain floor {floor:.4f} ms ({comp} chained "
                     f"compressions)")
        log(f"[{path}] {name} {variant}: kernel {ms:.4f} ms ({paced:.4f} ms "
            f"paced by the host), plain {plain_ms:.2f} ms, bound {bound:.4f} "
            f"ms ({by}; {work}){chain}, max_abs_err={err}")
        rows.append(row)
    tot = {}
    for name, args in log_calls:
        kern = getattr(stark_kernels, name)
        key = K7_LAUNCH_KEY.get(name, name)     # the tree launch under K7a
        t = tot.setdefault(key, {"launches": 0, "ms": 0.0, "paced_ms": 0.0,
                                 "bound_ms": 0.0})
        before = stark_kernels.LAUNCHES[key]
        kern(*args)
        t["launches"] += stark_kernels.LAUNCHES[key] - before
        t["ms"] += cuda_ms(lambda: kern(*args), reps=2)
        t["paced_ms"] += cuda_ms(lambda: kern(*args), reps=2, paced=True)
        t["bound_ms"] += k7_bound_ms(name, args, imad_rate)[0]
    for name, t in sorted(tot.items()):
        log(f"[{path} warm proof] {name}: {t['launches']} launches, kernel "
            f"{t['ms']:.4f} ms in all ({t['paced_ms']:.4f} ms paced by the "
            f"host), bound {t['bound_ms']:.4f} ms "
            f"({100 * t['bound_ms'] / max(t['ms'], 1e-9):.1f}% of the time)")
    return rows, tot


def run_stark_phase5(recs, imad_rate):
    """Phase 5 for the stark engine's recorded warm proofs ({path:
    StarkRecorder})."""
    rows, per_proof = [], {}
    for path, rec in recs.items():
        r, per_proof[path] = time_stark_kernels(rec.log, imad_rate, path,
                                                rec.key_size, rec.groups)
        rows += r
        rec.log = []
    return rows, per_proof


# the path whose warm API proof gives each K7 kernel's entry in the kernels line
K7_MAIN_PATH = {"blake2s": "stark chacha20 128 B",
                "circle_layer": "stark chacha20 128 B",
                "composition": "stark chacha20 128 B",
                "aes_composition": "stark aes-128-ctr 80 B"}


def stark_kernel_entries(rows, per_proof, launches, err):
    """The K7 entries of the kernels line: each kernel at its largest
    instance of the warm API proof of its path (K7a-c: the chacha20
    128-byte chunk, launches from phase 9; K7d: the aes-128-ctr 80-byte
    chunk, launches from phase 10), with the launches of every path's warm
    API proof beside them (phase 11's stark-stwo chunk too). launches:
    {path: counts}."""
    entries = []
    for name in StarkRecorder.NAMES:
        if name in K7_LAUNCH_KEY:               # listed under its kernel's entry
            continue
        mine = [r for r in rows
                if K7_LAUNCH_KEY.get(r["name"], r["name"]) == name]
        path = K7_MAIN_PATH[name]
        main = max((r for r in mine if r["path"] == path),
                   key=lambda r: r["bound_ms"])
        replaces = (K7B_EVALUATE_REPLACES if main["variant"].startswith("evaluate")
                    else K7_REPLACES[main["name"]])
        entries.append({
            "name": name, "route": "cuda",
            "source": "zksc_tpu_torch/csrc/stark_kernels.cu",
            "replaces": replaces, "launcher": main["name"],
            "launches": launches[path][name],
            "max_abs_err": err, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "path": main["path"], "shape": main["variant"],
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            "per_proof": {p: t[name] for p, t in per_proof.items() if name in t},
            "variants": mine})
    return entries


def profile_proof(prove):
    """torch.profiler over one proof: device time by kernel and the
    device's busy share of the proof's (profiled) wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        prove()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev(e) > 0]
    busy = sum(dev(e) for e in kernels)
    ours = [e for e in kernels if "zksc" in e.key]
    log(f"profile: proof wall {wall_ms:.2f} ms (profiler on), device busy "
        f"{busy:.2f} ms ({100 * busy / wall_ms:.1f}%), {len(kernels)} kernel "
        f"names, {sum(e.count for e in kernels)} launches")
    log(f"profile: the port's kernels {sum(dev(e) for e in ours):.3f} ms in "
        f"{sum(e.count for e in ours)} launches")
    for e in sorted(kernels, key=dev, reverse=True)[:12] + ours:
        log(f"profile: {dev(e):9.3f} ms {e.count:6d} x {e.key[:100]}")


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "zksc_tpu_torch")):
        print("chip_smoke: zksc_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if argv[:1] == ["--mesh-worker"]:           # one of phase 13's processes
        return mesh_worker(argv[1:])

    # ---- 1. environment
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"phase 1 environment: torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {name}, count "
        f"{torch.cuda.device_count()}")
    print(nvidia_smi("name,power.limit"), flush=True)
    props = torch.cuda.get_device_properties(0)
    max_clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    imad_rate = IMAD_PER_CLK_PER_SM * props.multi_processor_count * max_clk_mhz * 1e6
    log(f"SMs {props.multi_processor_count}, max SM clock {max_clk_mhz} MHz, "
        f"IMAD rate {imad_rate:.4g}/s")

    # ---- 2. build: every nvcc started together
    from zksc_tpu_torch.native import tape_lib
    from zksc_tpu_torch.ops import cuda_build, ec_kernels, h_kernels, msm_kernels
    from zksc_tpu_torch.ops import msm_glue, stark_kernels
    t = time.time()
    nvcc = cuda_build.build(verbose=True)
    log(f"phase 2 build: nvcc " + ", ".join(
        f"{cuda_build.LIBS[k][2]} {s:.2f} s" for k, (s, _) in nvcc.items())
        + f" (wall {time.time() - t:.2f} s)")
    for lib, (_, log_text) in sorted(nvcc.items()):
        for kernel, regs, stack, spill_st, spill_ld in ptxas_summary(log_text):
            log(f"phase 2 {lib} {kernel}: {regs} registers, {stack} B stack, "
                f"spill {spill_st} B stores / {spill_ld} B loads")
    t = time.time()
    if tape_lib() is None:
        raise RuntimeError("g++ build of the witness-tape library failed")
    log(f"phase 2 build: g++ libzksc_tape.so {time.time() - t:.2f} s")

    def reset_counts():
        ec_kernels.reset_launch_counts()
        msm_kernels.reset_launch_counts()
        stark_kernels.reset_launch_counts()
        h_kernels.reset_launch_counts()
        msm_glue.reset_launch_counts()

    def counts():
        return {**ec_kernels.LAUNCHES, **msm_kernels.LAUNCHES,
                **stark_kernels.LAUNCHES, **h_kernels.LAUNCHES,
                **msm_glue.LAUNCHES}

    from zksc_tpu_torch import api
    if "--toprf" in argv:
        # one -toprf statement alone: its phase 8 and its phase 5 replay
        alg = argv[argv.index("--toprf") + 1]
        if alg not in TOPRF_ALGS:
            raise ValueError(f"--toprf takes one of {TOPRF_ALGS}")
        rec = Recorder()
        drive_toprf(api, alg, reset_counts, counts, rec)
        time_kernels(rec.calls, imad_rate, alg)
        proof_totals(rec.log, imad_rate, alg, counts, reset_counts)
        time_h_kernels(rec.h_calls, imad_rate, alg)
        h_proof_totals(rec.h_log, imad_rate, alg, counts, reset_counts)
        time_glue_kernels(rec.glue_calls, imad_rate, alg)
        glue_proof_totals(rec.glue_log, imad_rate, alg, counts, reset_counts)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # ---- 3. kernels vs plain at check sizes
    g1a, g1b, g2h = load_points(device)
    err = check_kernels(g1a, g1b, g2h, imad_rate)
    k3_err, k3_plain_ms = check_ladder(g1a, g2h, imad_rate)
    err = max(err, k3_err, check_wide_windows(g1a, g2h))
    err = max(err, check_glue_kernels(g1a, g2h, imad_rate))
    check_stable_sort()
    err = max(err, check_stark_kernels(device, imad_rate))
    err = max(err, check_h_kernels(device, imad_rate))
    sweep_merkle_crossover(device)
    log(f"phase 3 kernel checks passed (max_abs_err {err})")
    del g1a, g1b, g2h

    # ---- 4. chacha20 main path at full size
    import random
    rnd = random.Random(2024)
    key = bytes(rnd.randrange(256) for _ in range(32))
    iv = bytes(rnd.randrange(256) for _ in range(12))
    ct = bytes(rnd.randrange(256) for _ in range(128))
    blind = random.Random(7)
    rng = lambda: blind.randrange(1, 1 << 250)
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    env = api.generate_proof("chacha20", key, ct, iv, device="cuda", rng=rng)
    log(f"phase 4 proof 1 (keys load + context + prove): "
        f"{time.time() - t:.2f} s")
    op = api.get_operator("chacha20", "groth16", "cuda")
    torch.cuda.synchronize()
    reset_counts()
    rec_chacha = Recorder()
    with rec_chacha:
        rec_chacha.window = True
        t = time.time()
        env = api.generate_proof("chacha20", key, ct, iv, device="cuda",
                                 rng=rng)
        torch.cuda.synchronize()
        prove_s = time.time() - t
        rec_chacha.window = False
    launches = counts()
    stages = " ".join(f"{k}={v:.3f}" for k, v in op.timings.items())
    log(f"phase 4 proof 2: {prove_s:.3f} s ({stages}); launches {launches}")
    for k in ("chunk_scan", "jac_add_n") + H_NAMES + GLUE_NAMES:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 4 peak device memory {peak / 2**30:.3f} GiB")
    t = time.time()
    ok = api.verify_proof(env, ct, iv, device="cuda")
    log(f"phase 4 verify: {ok} ({time.time() - t:.2f} s)")
    if not ok:
        raise AssertionError("the port's verifier rejected the proof")
    bad = bytes([ct[0] ^ 1]) + ct[1:]
    if api.verify_proof(env, bad, iv, device="cuda"):
        raise AssertionError("a tampered ciphertext verified")
    log("phase 4 tampered ciphertext rejected")
    msm_stage_check(api)

    # ---- 6. aes-128-ctr: keys made on the card, ceremony, proof
    rec_aes = Recorder()
    with rec_aes:
        aes_launches = drive_aes(api, reset_counts, counts, rec_aes)

    # ---- 7. the ladder branch of ProverContext
    rec_ladder = Recorder()
    with rec_ladder:
        ladder_launches = drive_ladder_branch(reset_counts, counts)

    # ---- 8. the TOPRF statements: chacha20-toprf at full width
    check_toprf_digests()
    rec_toprf = Recorder()
    drive_toprf(api, "chacha20-toprf", reset_counts, counts, rec_toprf)

    # ---- 9. the stark engine: chacha20, a 128-byte chunk and a 16 KiB record
    from zksc_tpu_torch.stark.stwo_compat import air as stwo_air
    stwo_groups = stwo_air.layout()[0]
    stark_recs = {"stark chacha20 128 B": StarkRecorder(),
                  "stark chacha20 16 KiB": StarkRecorder(),
                  "stark aes-128-ctr 80 B": StarkRecorder(16),
                  "stark aes-256-ctr 16 KiB": StarkRecorder(32),
                  "stark-stwo chacha20 128 B": StarkRecorder(groups=stwo_groups),
                  "stark-stwo chacha20 16 KiB": StarkRecorder(groups=stwo_groups)}
    stark_launches = {"stark chacha20 128 B": drive_stark(
        api, reset_counts, counts, stark_recs["stark chacha20 128 B"],
        stark_recs["stark chacha20 16 KiB"])}

    # ---- 10. the stark engine: aes-128-ctr and aes-256-ctr
    t = time.time()
    stark_launches["stark aes-128-ctr 80 B"] = drive_stark_aes(
        api, reset_counts, counts, stark_recs)
    log(f"phase 10 added {time.time() - t:.2f} s")

    # ---- 11. the stark-stwo engine: chacha20, stwo's bytes
    t = time.time()
    stark_launches["stark-stwo chacha20 128 B"] = drive_stwo(
        api, reset_counts, counts, stark_recs["stark-stwo chacha20 128 B"],
        stark_recs["stark-stwo chacha20 16 KiB"])
    log(f"phase 11 added {time.time() - t:.2f} s")

    # ---- 12. the interop layer: gnark / snarkjs codecs, .zkey, an imported
    # gnark circuit, the device AES keystream, LimbField, tracing
    t = time.time()
    drive_interop(api, key, ct, iv, env, rng, reset_counts, counts)
    log(f"phase 12 added {time.time() - t:.2f} s")

    # ---- 13. the multi-device layer: meshes of shards on the card, two
    # processes, the port's tools
    t = time.time()
    rec_mesh = Recorder()
    mesh_launches = drive_mesh(api, reset_counts, counts, rec_mesh)
    log(f"phase 13 added {time.time() - t:.2f} s")

    # ---- 14. the batched Groth16 path: k proofs in one pass
    rec_batch = {"chacha20": Recorder(), "aes-128-ctr": Recorder()}
    batch_launches = drive_batch(api, reset_counts, counts, rec_batch)

    # ---- 5. kernels at the paths' shapes
    rows = (time_kernels(rec_chacha.calls, imad_rate, "chacha20")
            + time_kernels(rec_aes.calls, imad_rate, "aes-128-ctr")
            + time_kernels(rec_ladder.calls, imad_rate, "ladder branch")
            + time_kernels(rec_toprf.calls, imad_rate, "chacha20-toprf")
            + time_kernels(rec_batch["chacha20"].calls, imad_rate,
                           "chacha20 k=4")
            + time_kernels(rec_batch["aes-128-ctr"].calls, imad_rate,
                           "aes-128-ctr k=4"))
    per_proof = {}
    for path, rec in (("chacha20", rec_chacha), ("aes-128-ctr", rec_aes),
                      ("chacha20-toprf", rec_toprf),
                      ("chacha20 k=4", rec_batch["chacha20"]),
                      ("aes-128-ctr k=4", rec_batch["aes-128-ctr"])):
        per_proof[path] = proof_totals(rec.log, imad_rate, path, counts,
                                       reset_counts)
        rec.log = []
    h_rows, h_per_proof = [], {}
    for path, rec in (("chacha20", rec_chacha), ("aes-128-ctr", rec_aes),
                      ("chacha20-toprf", rec_toprf),
                      ("chacha20 k=4", rec_batch["chacha20"]),
                      ("aes-128-ctr k=4", rec_batch["aes-128-ctr"]),
                      ("chacha20 mesh D=4", rec_mesh)):
        h_rows += time_h_kernels(rec.h_calls, imad_rate, path)
        h_per_proof[path] = h_proof_totals(rec.h_log, imad_rate, path,
                                           counts, reset_counts)
        rec.h_calls, rec.h_log = {}, []
    glue_rows, glue_per_proof = [], {}
    for path, rec in (("chacha20", rec_chacha), ("aes-128-ctr", rec_aes),
                      ("chacha20-toprf", rec_toprf),
                      ("chacha20 k=4", rec_batch["chacha20"]),
                      ("aes-128-ctr k=4", rec_batch["aes-128-ctr"])):
        glue_rows += time_glue_kernels(rec.glue_calls, imad_rate, path)
        glue_per_proof[path] = glue_proof_totals(rec.glue_log, imad_rate,
                                                 path, counts, reset_counts)
        rec.glue_calls, rec.glue_log = {}, []
    t = time.time()
    stark_rows, stark_per_proof = run_stark_phase5(stark_recs, imad_rate)
    log(f"phase 5 stark replays: {time.time() - t:.2f} s")
    log("phase 5 kernel timing done")
    if "--profile" in argv:
        profile_proof(lambda: api.generate_proof("chacha20", key, ct, iv,
                                                 device="cuda", rng=rng))
    err = max([err] + [r["max_abs_err"]
                       for r in rows + stark_rows + h_rows + glue_rows])

    def head(name, replaces, source, path, variant, n_launch, plain_ms=None):
        r = next(r for r in rows if r["name"] == name and r["path"] == path
                 and r["variant"] == variant)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": err, "ms": r["ms"],
                "plain_ms": r["plain_ms"] if plain_ms is None else plain_ms,
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None, "path": path,
                "shape": f"{variant} {r['shape']}",
                "per_proof": {p: t[name] for p, t in per_proof.items()
                              if name in t},
                "variants": [v for v in rows if v["name"] == name]}

    ec_src = "zksc_tpu_torch/csrc/ec_kernels.cu"
    print(json.dumps({"kernels": [
        dict(head("chunk_scan", "zksc_tpu/ops/pallas_ec.py:120", ec_src,
                  "chacha20", "G1 inclusive=True", launches["chunk_scan"]),
             launches_mesh4=mesh_launches["chacha20"]["chunk_scan"],
             launches_batch4={a: n["chunk_scan"]
                              for a, n in batch_launches.items()}),
        dict(head("jac_add_n", "zksc_tpu/ops/pallas_ec.py:162", ec_src,
                  "chacha20", "G1 complete=True", launches["jac_add_n"]),
             launches_mesh4=mesh_launches["chacha20"]["jac_add_n"],
             launches_batch4={a: n["jac_add_n"]
                              for a, n in batch_launches.items()}),
        # K3's plain time is that of the check size (phase 3, N=4,096 x 32
        # bits): the plain ladder at the ceremony's shape takes minutes
        dict(head("ladder", "zksc_tpu/ops/pallas_msm.py:58",
                  "zksc_tpu_torch/csrc/msm_kernels.cu", "aes-128-ctr",
                  "G1 unreduced shared bits", aes_launches["ladder"],
                  k3_plain_ms["G1 unreduced shared bits"]),
             plain_shape="G1 unreduced shared bits N=4096 bits=32",
             launches_ladder_branch=ladder_launches["ladder"],
             launches_mesh4_ladder_branch=mesh_launches["ladder"]["ladder"]),
    ] + stark_kernel_entries(stark_rows, stark_per_proof, stark_launches, err)
      + h_kernel_entries(h_rows, h_per_proof, launches, batch_launches,
                         mesh_launches["chacha20"], err)
      + glue_kernel_entries(glue_rows, glue_per_proof, launches,
                            batch_launches, mesh_launches["chacha20"], err)}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

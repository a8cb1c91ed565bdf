// Hand-written Hopper (sm_90a) kernels for the Circle-STARK engine ("stark").
//
// No Pallas kernel lies on this path: in the JAX package XLA fuses the circle
// FFT and the composition and the Merkle leaves are hashed by hashlib. PyTorch
// eager fuses nothing (a Blake2s compression is ~1,100 eager ops, the
// composition's temporaries would be 0.4-0.9 GB each), so the port writes:
//
// K7a blake2s -- zksc_tpu/stark/blake2s.py:blake2s / blake2s_pair and
//    zksc_tpu/stark/merkle.py:commit: Blake2s-256 (RFC 7693), one thread
//    a message, the state in registers, the next block's words loaded while
//    the current one is compressed. Two launches: blake2s_kernel hashes
//    loose messages from a strided source (word j of message i at
//    base[i * msg_stride + j * word_stride]); blake2s_tree_kernel builds a
//    whole Merkle tree in one launch, every node layer included. Its
//    blocks take 32 leaves each (1,024 leaves spread over 32 SMs), hash
//    them, then their subtree's node layers in shared memory, writing every
//    layer to its slice of one buffer; the last block to finish (an atomic ticket after
//    a fence) hashes the top layers to the root. The trace leaves are the
//    columns of the [C, M] LDE, read in place (a warp's threads read
//    neighbouring words). Bound: a leaf's compressions chain, so the floor
//    is one message's compressions x one compression on one warp -- 823
//    ALU-pipe instructions at 2 clocks each (16-lane pipes), 1,646 clocks;
//    the loop issues ~1,050 a compression and runs at ~90% of that floor.
//    The roofline bound (every compression at the card's integer rate) is
//    8-500x lower and out of reach with 32-2,048 leaves. (A producer warp
//    staging the words into a shared-memory ring by cp.async.bulk was
//    measured 1-3% slower than these direct loads, PERF.md.)
// K7b circle_fft / circle_layer -- zksc_tpu/stark/circle.py:
//    CircleFFT.interpolate / evaluate over a batch of C columns of N values
//    (the y-fold and the x-folds through pi(x) = 2x^2 - 1). A column is at
//    most 128 KB up to N = 2^15, so circle_fft_kernel runs a whole transform
//    in one launch: a block loads its columns once (16-byte loads), runs
//    every layer in shared memory and stores once; small N puts several
//    columns in a block. The x-layers go two at a time: a thread reads four
//    values, folds them through both layers in registers, meets the block
//    at a barrier and writes them in place (the y-layer and an odd x-layer
//    alone, two values a butterfly). Evaluate reads only the K <= N
//    coefficients that can be non-zero (the LDE's N + 50) and skips the
//    arithmetic of the x-layers whose upper half is still zero. Bound: the
//    butterflies' integer operations (12-15 issue slots each; a canonical
//    M31 product is 5), not the bytes, which are read and written once;
//    the index arithmetic and shared-memory traffic come on top. Above
//    2^15 circle_layer_kernel runs one launch a layer, one thread a
//    butterfly, through device memory (bound: bytes).
// K7c composition -- zksc_tpu/stark/prover.py:_composition: for every LDE
//    point x, sum_k w_k * c_k(x) over the AIR's constraints (bool, add, addx,
//    xor, eq, in that order) with QM31 weights w_k, then times V_N(x)^-1.
//    A 2-D grid of point tiles x slices of up to 128
//    constraints: each block first copies its slice's row indices and
//    weights to shared memory, so a value is one shared read and one
//    global gather (32-bit offsets while R * M < 2^31); a thread takes
//    one, two or four neighbouring points (up to 16-byte gathers) and issues
//    the gathers of four constraints before it uses them; each component
//    accumulates as a 64-bit multiply-add, folded once every four terms.
//    The wrapper picks the shape by M (composition_plan): at M = 32 one-warp
//    tiles and slices of 32 constraints, ~1,700 blocks. A second launch
//    adds the slices' partials (32 rows of threads a block of outputs) and
//    multiplies by vn_inv. Addition mod p is exact, so any
//    summation order gives the reference's values. Bound: integer
//    operations, or the bytes if the gathers miss the caches.
// K7d aes_composition -- zksc_tpu/stark/aes_prover.py:_composition: K7c's
//    form for the AES-CTR LogUp AIR. An "item" is one bool, const, xor, mix
//    or eq constraint, one lookup instance (its four QM31 constraints, with
//    weights base + 4j + c) or the table's four constraints; the cum
//    column's four are linear in their parts, so they are cut into a cum
//    item (cum at x and sigma x, G at sigma x) and one cumlk item a lookup
//    instance (its F columns at sigma x, subtracted). Item kinds in
//    alpha-power order: bool | const | xor | mix | lookup | table | cum |
//    cumlk | eq. The grid is slices of consecutive items (cut so that each
//    gathers about 256 values) x point tiles; from 8 point tiles on (M =
//    8,192) the slices go fastest, so blocks resident together share one
//    tile's rows in L2, below it the tiles. A block first copies
//    its slice's header, its items' rows (times M for 32-bit offsets) and
//    its weight rows to shared memory (the host builds the table once,
//    ops/stark_kernels.aes_slice_table). A thread takes one, two or four
//    neighbouring points (composition_plan's choice by M: 4-, 8- or 16-byte
//    gathers; the sigma-shifted values are read as vals[row, perm[x]] in
//    place, one a point), issues the gathers of up to four items before it
//    uses them, and multiply-adds each term into u64 components folded once
//    every four terms. The summing launch is K7c's. Bound: integer
//    operations (~30.5k values gathered a point for AES-128 at 10 issue
//    slots a term), or the gathered bytes if they miss the caches.
//
// Values at the boundary are canonical M31 residues in int32 (read here as
// uint32); the wrappers are ops/stark_kernels.py.
#include <cuda_runtime.h>

#include <cstdint>

#include "m31.cuh"

namespace zksc {

constexpr int kStarkThreads = 128;

inline unsigned stark_grid(long long n) {
  long long blocks = (n + kStarkThreads - 1) / kStarkThreads;
  if (blocks > 65535) blocks = 65535;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

// ------------------------------------------------------------------ K7a

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

#define ZK_G(a, b, c, d, x, y)       \
  v[a] = v[a] + v[b] + (x);          \
  v[d] = rotr32(v[d] ^ v[a], 16);    \
  v[c] = v[c] + v[d];                \
  v[b] = rotr32(v[b] ^ v[c], 12);    \
  v[a] = v[a] + v[b] + (y);          \
  v[d] = rotr32(v[d] ^ v[a], 8);     \
  v[c] = v[c] + v[d];                \
  v[b] = rotr32(v[b] ^ v[c], 7);

// one round; s0..s15 is the round's row of the message schedule SIGMA
#define ZK_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  ZK_G(0, 4, 8, 12, m[s0], m[s1])                                                     \
  ZK_G(1, 5, 9, 13, m[s2], m[s3])                                                     \
  ZK_G(2, 6, 10, 14, m[s4], m[s5])                                                    \
  ZK_G(3, 7, 11, 15, m[s6], m[s7])                                                    \
  ZK_G(0, 5, 10, 15, m[s8], m[s9])                                                    \
  ZK_G(1, 6, 11, 12, m[s10], m[s11])                                                  \
  ZK_G(2, 7, 8, 13, m[s12], m[s13])                                                   \
  ZK_G(3, 4, 9, 14, m[s14], m[s15])

__device__ __forceinline__ void blake2s_compress(uint32_t h[8], const uint32_t m[16],
                                                 unsigned long long t, bool last) {
  uint32_t v[16] = {h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7],
                    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
  v[12] ^= (uint32_t)t;
  v[13] ^= (uint32_t)(t >> 32);
  if (last) v[14] = ~v[14];
  ZK_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  ZK_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  ZK_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  ZK_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  ZK_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  ZK_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  ZK_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  ZK_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  ZK_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  ZK_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

#undef ZK_ROUND
#undef ZK_G

__device__ __forceinline__ void blake2s_init(uint32_t h[8]) {
  h[0] = 0x6A09E667u ^ 0x01010020u;       // parameter block: 32-byte digest
  h[1] = 0xBB67AE85u, h[2] = 0x3C6EF372u, h[3] = 0xA54FF53Au;
  h[4] = 0x510E527Fu, h[5] = 0x9B05688Cu, h[6] = 0x1F83D9ABu, h[7] = 0x5BE0CD19u;
}

// One message of `len` bytes, little-endian in the words src[j * ws], read
// by this thread. Every block but the last is full; the last block holds
// the rest of the message, zero-padded (bytes past `len` of its last word
// are masked), and t counts bytes, as RFC 7693 has it. An empty message is
// one zero block with t = 0. The next block's words are loaded while the
// current one is compressed.
__device__ __forceinline__ void blake2s_message(const uint32_t* __restrict__ src, long long len,
                                                long long ws, uint32_t h[8]) {
  const long long n_blocks = len > 0 ? (len + 63) / 64 : 1;
  const long long n_words = (len + 3) / 4;
  blake2s_init(h);
  uint32_t m[16], nxt[16];
  if (n_blocks > 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j) nxt[j] = src[j * ws];
  }
  for (long long blk = 0; blk + 1 < n_blocks; ++blk) {
#pragma unroll
    for (int j = 0; j < 16; ++j) m[j] = nxt[j];
    if (blk + 2 < n_blocks) {                 // the next full block, in flight
      const uint32_t* nb = src + (blk + 1) * 16 * ws;
#pragma unroll
      for (int j = 0; j < 16; ++j) nxt[j] = nb[j * ws];
    }
    blake2s_compress(h, m, (unsigned long long)(blk + 1) * 64, false);
  }
  const long long w0 = (n_blocks - 1) * 16;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const long long w = w0 + j;
    uint32_t x = 0;
    if (w < n_words) {
      x = src[w * ws];
      const long long tail = len - 4 * w;     // bytes of this word in the message
      if (tail < 4) x &= (1u << (8 * tail)) - 1u;
    }
    m[j] = x;
  }
  blake2s_compress(h, m, (unsigned long long)len, true);
}

// K7a for loose messages: message i at src = base + i * ms, one thread each.
__global__ void __launch_bounds__(kStarkThreads)
    blake2s_kernel(const uint32_t* __restrict__ base, long long count, long long len,
                   long long ms, long long ws, uint32_t* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t h[8];
    blake2s_message(base + i * ms, len, ws, h);
#pragma unroll
    for (int k = 0; k < 8; ++k) out[i * 8 + k] = h[k];
  }
}

// ---- K7a's tree launch

constexpr int kTreeLeaves = 32;   // leaves a block, at most: one warp hashes them

// first digest of tree layer `level` (N leaves) in the output: the layers
// back to back, leaves first
__device__ __forceinline__ long long layer_at(long long N, int level) {
  return 2 * (N - (N >> level));
}

__device__ __forceinline__ void store_digest(uint32_t* __restrict__ out, long long node,
                                             const uint32_t h[8]) {
  uint4* o = reinterpret_cast<uint4*>(out + node * 8);
  o[0] = uint4{h[0], h[1], h[2], h[3]};
  o[1] = uint4{h[4], h[5], h[6], h[7]};
}

__device__ __forceinline__ void blake2s_node(const uint32_t m[16], uint32_t h[8]) {
  blake2s_init(h);
  blake2s_compress(h, m, 64ull, true);
}

// A whole Merkle tree in one launch. Block b takes leaves [b L, b L + L)
// (L = min(N, 32), one thread a leaf), hashes them, then its subtree's node
// layers in shared memory; every layer goes to its slice of `out` ([2N - 1,
// 8] words). The last block to finish (a ticket taken after a fence) hashes
// the layers above the block roots, up to the root. The ticket is zeroed on
// the stream before each launch (zksc_blake2s_tree), so no launch depends on
// how an earlier one ended.
__global__ void __launch_bounds__(kStarkThreads)
    blake2s_tree_kernel(const uint32_t* __restrict__ base, long long N, int L, long long len,
                        long long ms, long long ws, uint32_t* __restrict__ out,
                        unsigned* __restrict__ ticket) {
  __shared__ uint32_t dig[8][kTreeLeaves];
  __shared__ unsigned last;
  const int t = threadIdx.x;
  const long long x0 = (long long)blockIdx.x * L;
  uint32_t h[8];
  if (t < L) {
    blake2s_message(base + (x0 + t) * ms, len, ws, h);
    store_digest(out, x0 + t, h);
#pragma unroll
    for (int k = 0; k < 8; ++k) dig[k][t] = h[k];
  }
  __syncthreads();
  int level = 1;
  for (int n = L >> 1; n >= 1; n >>= 1, ++level) {     // the block's subtree
    uint32_t m[16];
    const bool act = t < n;
    if (act) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        m[k] = dig[k][2 * t];
        m[8 + k] = dig[k][2 * t + 1];
      }
      blake2s_node(m, h);
    }
    __syncthreads();
    if (act) {
#pragma unroll
      for (int k = 0; k < 8; ++k) dig[k][t] = h[k];
      store_digest(out, layer_at(N, level) + (x0 >> level) + t, h);
    }
    __syncthreads();
  }
  const long long G = N / L;                  // blocks, and block roots
  if (G == 1) return;
  __threadfence();                            // this block's layers, then its ticket
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1u) == (unsigned)(G - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (long long n = G >> 1; n >= 1; n >>= 1, ++level) {  // the top layers
    const long long src = layer_at(N, level - 1), dst = layer_at(N, level);
    for (long long i = t; i < n; i += blockDim.x) {
      uint32_t m[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) m[k] = __ldcg(out + (src + 2 * i) * 8 + k);
      blake2s_node(m, h);
      store_digest(out, dst + i, h);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ K7b

// One layer over C columns of N = 2^log_n values, thread t < N/2 of a column
// taking one butterfly; w = 2^log_w is the layer's chunk width.
//   INTERP, !REV: interpolate's y-fold (w = N/2): lo = in[t], hi = in[N/2+t];
//   INTERP,  REV: an x-fold, chunks of 2w read as j*2w + p and j*2w+2w-1-p;
//   both write out[t] = (lo + hi)/2, out[N/2 + t] = (lo - hi)/2 * tw[p].
//   !INTERP: evaluate's layers, the inverse: a = in[t], b = in[N/2 + t],
//   out[j*2w + p] = a + tw[p] b and out[j*2w + 2w-1-p] (REV, an x-layer) or
//   out[N/2 + t] (!REV, the y-layer) = a - tw[p] b.
// (p = t mod w, j = t / w.) The same values as circle.py:103-135.
template <bool INTERP, bool REV>
__global__ void __launch_bounds__(kStarkThreads)
    circle_layer_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                        long long C, int log_n, int log_w, const uint32_t* __restrict__ tw) {
  const long long half = 1ll << (log_n - 1);
  const long long w = 1ll << log_w;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < C * half;
       g += (long long)gridDim.x * blockDim.x) {
    const long long col = g >> (log_n - 1);
    const long long t = g & (half - 1);
    const long long j = t >> log_w, p = t & (w - 1);
    const uint32_t* src = in + (col << log_n);
    uint32_t* dst = out + (col << log_n);
    if (INTERP) {
      const uint32_t lo = REV ? src[j * 2 * w + p] : src[t];
      const uint32_t hi = REV ? src[j * 2 * w + 2 * w - 1 - p] : src[half + t];
      dst[t] = m31_mul(m31_add(lo, hi), kInv2);
      dst[half + t] = m31_mul(m31_mul(m31_sub(lo, hi), kInv2), tw[p]);
    } else {
      const uint32_t a = src[t];
      const uint32_t tb = m31_mul(tw[p], src[half + t]);
      dst[REV ? j * 2 * w + p : t] = m31_add(a, tb);
      dst[REV ? j * 2 * w + 2 * w - 1 - p : half + t] = m31_sub(a, tb);
    }
  }
}

// ---- K7b's one-launch transform

constexpr int kFftMaxLog = 15;                  // 2^15 values (128 KB) a column, at most
constexpr int kFftMaxSmem = 4 << kFftMaxLog;    // the dynamic shared memory it asks for

// a / 2 mod p for canonical a: (a + p) / 2 = (a >> 1) + 2^30 when a is odd
__device__ __forceinline__ uint32_t m31_half(uint32_t a) {
  return (a >> 1) | ((a & 1u) << 30);
}

// One layer of the transform on a column s[0, N) in shared memory, in
// place: each thread reads its B butterflies' pairs (t = tc + i T) and
// computes them, the block meets, the thread writes, the block meets.
// Forms and twiddles (tw: the layer's 2^lw) as circle_layer_kernel, with
// interpolate's twiddles pre-halved: (lo - hi) / 2 * tw = (lo - hi) * (tw / 2).
template <bool INTERP, bool REV, int B>
__device__ __forceinline__ void fft_layer(uint32_t* s, int half, int lw, int tc, int log_t,
                                          const uint32_t* __restrict__ tw) {
  const int w = 1 << lw;
  uint32_t r0[B], r1[B];
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int t = tc + (i << log_t);
    const int j = t >> lw, p = t & (w - 1);
    const uint32_t k = tw[p];
    if (INTERP) {
      const uint32_t lo = s[REV ? 2 * j * w + p : t];
      const uint32_t hi = s[REV ? 2 * j * w + 2 * w - 1 - p : half + t];
      r0[i] = m31_half(m31_add(lo, hi));
      r1[i] = m31_mulc(m31_sub(lo, hi), k);
    } else {
      const uint32_t a = s[t];
      const uint32_t kb = m31_mulc(k, s[half + t]);
      r0[i] = m31_add(a, kb);
      r1[i] = m31_sub(a, kb);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int t = tc + (i << log_t);
    const int j = t >> lw, p = t & (w - 1);
    const bool out_rev = !INTERP && REV;
    s[out_rev ? 2 * j * w + p : t] = r0[i];
    s[out_rev ? 2 * j * w + 2 * w - 1 - p : half + t] = r1[i];
  }
  __syncthreads();
}

// An evaluate x-layer whose upper half is zero (the column's values lie in
// [0, ext), ext <= N / 2): b = 0, so the butterflies t < ext copy a to both
// of their outputs and the rest write zeros over zeros. No arithmetic.
template <int B>
__device__ __forceinline__ void fft_spread(uint32_t* s, int ext, int lw, int tc, int log_t) {
  const int w = 1 << lw;
  uint32_t a[B];
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int t = tc + (i << log_t);
    a[i] = t < ext ? s[t] : 0u;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < B; ++i) {
    const int t = tc + (i << log_t);
    const int j = t >> lw, p = t & (w - 1);
    if (t < ext) {
      s[2 * j * w + p] = a[i];
      s[2 * j * w + 2 * w - 1 - p] = a[i];
    }
  }
  __syncthreads();
}

// Two interpolate x-folds in one pass (widths w, then w / 2; w >= 2): unit
// u = j w/2 + p (p < w/2) reads s[2jw + {p, w-1-p, w+p, 2w-1-p}], folds
// the butterflies (j, p) and (j, w-1-p) of width w and then, in registers,
// the two of width w/2 their results meet in, and writes s[u], s[half/2 +
// u], s[half + u], s[3 half/2 + u]. tw, tw2: the two layers' twiddles.
template <int U>
__device__ __forceinline__ void fft_fold2(uint32_t* s, int half, int lw, int tc, int log_t,
                                          const uint32_t* __restrict__ tw,
                                          const uint32_t* __restrict__ tw2) {
  const int w = 1 << lw, h = w >> 1;
  uint32_t r[U][4];
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int u = tc + (i << log_t);
    const int p = u & (h - 1);
    const uint32_t* x = s + 2 * (u >> (lw - 1)) * w;
    const uint32_t x0 = x[p], x1 = x[w - 1 - p], x2 = x[w + p], x3 = x[2 * w - 1 - p];
    const uint32_t g0 = m31_half(m31_add(x0, x3)), g1 = m31_mulc(m31_sub(x0, x3), tw[p]);
    const uint32_t g2 = m31_half(m31_add(x1, x2)), g3 = m31_mulc(m31_sub(x1, x2), tw[w - 1 - p]);
    const uint32_t k = tw2[p];
    r[i][0] = m31_half(m31_add(g0, g2));
    r[i][1] = m31_mulc(m31_sub(g0, g2), k);
    r[i][2] = m31_half(m31_add(g1, g3));
    r[i][3] = m31_mulc(m31_sub(g1, g3), k);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int u = tc + (i << log_t);
    s[u] = r[i][0];
    s[half + u] = r[i][1];
    s[(half >> 1) + u] = r[i][2];
    s[half + (half >> 1) + u] = r[i][3];
  }
  __syncthreads();
}

// Two evaluate x-layers in one pass (widths w, then 2w; 2w <= N/4): unit u
// = jw + p (p < w) reads s[u], s[half + u], s[half/2 + u], s[3 half/2 + u]
// (the butterflies (j, p) and (j + half/2w, p) of width w), then the two
// of width 2w their results meet in, and writes s[4jw + {p, 2w-1-p, 2w+p,
// 4w-1-p}]. tw, tw2: the two layers' twiddles.
template <int U>
__device__ __forceinline__ void fft_spread2(uint32_t* s, int half, int lw, int tc, int log_t,
                                            const uint32_t* __restrict__ tw,
                                            const uint32_t* __restrict__ tw2) {
  const int w = 1 << lw;
  uint32_t r[U][4];
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int u = tc + (i << log_t);
    const int p = u & (w - 1);
    const uint32_t k = tw[p];
    const uint32_t b0 = m31_mulc(k, s[half + u]), b2 = m31_mulc(k, s[half + (half >> 1) + u]);
    const uint32_t a0 = s[u], a2 = s[(half >> 1) + u];
    const uint32_t c0 = m31_add(a0, b0), c1 = m31_sub(a0, b0);
    const uint32_t c2 = m31_add(a2, b2), c3 = m31_sub(a2, b2);
    const uint32_t e0 = m31_mulc(tw2[p], c2), e1 = m31_mulc(tw2[2 * w - 1 - p], c3);
    r[i][0] = m31_add(c0, e0);
    r[i][1] = m31_sub(c0, e0);
    r[i][2] = m31_add(c1, e1);
    r[i][3] = m31_sub(c1, e1);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int u = tc + (i << log_t);
    const int p = u & (w - 1);
    uint32_t* x = s + 4 * (u >> lw) * w;
    x[p] = r[i][0];
    x[4 * w - 1 - p] = r[i][1];
    x[2 * w - 1 - p] = r[i][2];
    x[2 * w + p] = r[i][3];
  }
  __syncthreads();
}

// A whole CircleFFT.interpolate (INTERP: the y-fold, then every x-fold from
// the widest) or evaluate (every x-layer from the narrowest, then the
// y-layer) over columns [C, N], N = 2^log_n, in one launch. A block holds G
// = blockDim.x >> log_t columns in shared memory, 2^log_t threads a column
// and B butterflies a thread (B 2^log_t = N / 2). The block loads its
// columns once (16-byte loads where K and `in` allow), runs every layer in
// shared memory and stores once. The x-layers go two at a time (fft_fold2,
// fft_spread2: B / 2 four-value units a thread, half the barriers and
// shared-memory traffic), an odd one alone (fft_layer). Evaluate reads K
// <= N coefficients a column (in: [C, K]; the rest are zeros), and skips
// the arithmetic of the x-layers whose upper half is still zero. tw: every
// layer's twiddles packed, the layer of width w at tw[N - 2w] (the y-layer
// first); interpolate's inverted and halved.
template <bool INTERP, int B, int MAXT>
__global__ void __launch_bounds__(MAXT)
    circle_fft_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long long C,
                      int log_n, int K, int log_t, int vec,
                      const uint32_t* __restrict__ tw) {
  extern __shared__ uint4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const int N = 1 << log_n, half = N >> 1;
  const int G = (int)(blockDim.x >> log_t);
  const long long c0 = (long long)blockIdx.x * G;
  const int cols = (int)(C - c0 < G ? C - c0 : G);
  const int total = G << log_n;
  if (vec) {                                   // K % 4 == 0, `in` 16-byte aligned
    for (int e = 4 * threadIdx.x; e < total; e += 4 * blockDim.x) {
      const int g = e >> log_n, i = e & (N - 1);
      uint4 v = uint4{0u, 0u, 0u, 0u};
      if (g < cols && i < K) v = *reinterpret_cast<const uint4*>(in + (c0 + g) * K + i);
      smem4[e >> 2] = v;
    }
  } else {
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int g = e >> log_n, i = e & (N - 1);
      smem[e] = g < cols && i < K ? in[(c0 + g) * K + i] : 0u;
    }
  }
  __syncthreads();
  uint32_t* s = smem + ((threadIdx.x >> log_t) << log_n);
  const int tc = threadIdx.x & ((1 << log_t) - 1);
  const uint32_t* level = tw + N;               // the layer of width 2^lw at level - (2 << lw)
  if (INTERP) {
    fft_layer<true, false, B>(s, half, log_n - 1, tc, log_t, tw);
    int lw = log_n - 2;
    for (; lw >= 1; lw -= 2)
      fft_fold2<B / 2>(s, half, lw, tc, log_t, level - (2 << lw), level - (1 << lw));
    for (; lw >= 0; --lw) fft_layer<true, true, B>(s, half, lw, tc, log_t, level - (2 << lw));
  } else {
    int ext = K, lw = 0;                        // values past ext are zero
    for (; lw <= log_n - 2 && ext <= half; ++lw, ext <<= 1) fft_spread<B>(s, ext, lw, tc, log_t);
    for (; lw + 1 <= log_n - 2; lw += 2)
      fft_spread2<B / 2>(s, half, lw, tc, log_t, level - (2 << lw), level - (4 << lw));
    for (; lw <= log_n - 2; ++lw)
      fft_layer<false, true, B>(s, half, lw, tc, log_t, level - (2 << lw));
    fft_layer<false, false, B>(s, half, log_n - 1, tc, log_t, tw);
  }
  uint4* o = reinterpret_cast<uint4*>(out + (c0 << log_n));
  for (int e = threadIdx.x; e < (cols << log_n) >> 2; e += blockDim.x) o[e] = smem4[e];
}

// K7b's launch shape by N: a column takes T = N/4 threads (at least 1) up
// to N = 1,024, 256 to 4,096, then N/16 up to 1,024 threads, so B = N / 2T
// butterflies a thread is 2-16; a block takes 256 / T columns when T < 256.
template <bool INTERP, int B, int MAXT>
inline int launch_fft(const uint32_t* in, uint32_t* out, long long C, int log_n, int K,
                      int log_t, int vec, const uint32_t* tw, cudaStream_t st) {
  const int T = 1 << log_t;
  const int G = T < 256 ? 256 / T : 1;
  const int smem = (G << log_n) * 4;
  if (smem > 48 * 1024) {   // set at each such launch, so that it holds on whichever card runs it
    const cudaError_t e = cudaFuncSetAttribute(circle_fft_kernel<INTERP, B, MAXT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kFftMaxSmem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (C + G - 1) / G;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  circle_fft_kernel<INTERP, B, MAXT><<<dim3((unsigned)blocks), dim3(G * T), smem, st>>>(
      in, out, C, log_n, K, log_t, vec, tw);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K7c

constexpr int kGroups = 5;          // bool, add, addx, xor, eq
constexpr int kMaxFields = 6;       // index fields of a constraint, at most (addx)
constexpr int kSliceMax = 128;      // constraints a slice holds, at most

struct Groups {
  const int32_t* idx;        // packed: group g's field f of constraint i at
  long long off[kGroups];    //   idx[off[g] + f * n[g] + i]
  long long n[kGroups];
};

__host__ __device__ constexpr int group_fields(int g) {
  return g == 0 ? 1 : g == 1 ? 5 : g == 2 ? 6 : 3;
}

// c_k(x) of a constraint of group G from its gathered values f (canonical)
template <int G>
__device__ __forceinline__ uint32_t constraint(const uint32_t* f) {
  constexpr uint64_t P = kP31;
  if (G == 0) {                           // b (1 - b)
    const uint64_t b = f[0];
    return m31_red(b * (1 + P - b));
  }
  if (G == 1) {                           // R + 2C - (A + B + Cin)
    return m31_red((uint64_t)f[2] + 2ull * f[3] + 3 * P - f[0] - f[1] - f[4]);
  }
  if (G == 2) {                           // R + 2C - ((U + W - 2UW) + B + Cin)
    const uint64_t u = f[0], w = f[1];
    const uint64_t uw = m31_red(u * w);
    return m31_red((uint64_t)f[3] + 2ull * f[4] + 2 * uw + 4 * P - u - w - f[2] - f[5]);
  }
  if (G == 3) {                           // R + 2AB - (A + B)
    const uint64_t a = f[0], b = f[1];
    return m31_red((uint64_t)f[2] + 2 * (uint64_t)m31_red(a * b) + 2 * P - a - b);
  }
  const uint64_t ks = f[0], pt = f[1];    // KS + PT - (2 KS PT + CT)
  return m31_red(ks + pt + 3 * P - 2 * (uint64_t)m31_red(ks * pt) - f[2]);
}

// V neighbouring values from p (V * 4-byte aligned)
template <int V>
__device__ __forceinline__ void load_points(const uint32_t* __restrict__ p, uint32_t* v) {
  if constexpr (V == 4) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (V == 2) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// V neighbouring values to p (V * 4-byte aligned)
template <int V>
__device__ __forceinline__ void store_points(uint32_t* __restrict__ p, const uint32_t* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = uint4{v[0], v[1], v[2], v[3]};
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint2*>(p) = uint2{v[0], v[1]};
  } else {
    *p = v[0];
  }
}

// A folded sum is below 2^34: 2^32 = 2 (mod p), so lo + 2 hi <= 2^32 - 1 +
// 2^33 - 2. A term w * c is at most (p - 1)^2 = 2^62 - 2^33 + 4, so four
// terms and a folded sum stay below 2^64 - 2^34 + 2^4: the sum takes four
// terms per fold.
__device__ __forceinline__ uint64_t fold(uint64_t a) {
  return (a & 0xFFFFFFFFull) + 2 * (a >> 32);
}

// rows[f][j]: field f of the slice's constraint j, as the row's first
// value's offset row * M when Off is 32-bit (R * M < 2^31), else the row
template <typename Off>
__device__ __forceinline__ Off row_offset(uint32_t r, Off M) {
  if constexpr (sizeof(Off) == 4) {
    return r;
  } else {
    return (Off)r * M;
  }
}

template <int G, int U, typename Off, int V>
__device__ __forceinline__ void group_step(const uint32_t* __restrict__ vx, Off M,
                                           uint32_t (*rows)[kSliceMax],
                                           const uint4* __restrict__ w, int j,
                                           uint64_t acc[4][V]) {
  constexpr int F = group_fields(G);
  uint32_t v[U][F][V];
#pragma unroll
  for (int u = 0; u < U; ++u)             // every gather of the step in flight
#pragma unroll
    for (int f = 0; f < F; ++f) load_points<V>(vx + row_offset<Off>(rows[f][j + u], M), v[u][f]);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const uint4 wk = w[j + u];
#pragma unroll
    for (int p = 0; p < V; ++p) {
      uint32_t fv[F];
#pragma unroll
      for (int f = 0; f < F; ++f) fv[f] = v[u][f][p];
      const uint32_t c = constraint<G>(fv);
      acc[0][p] += (uint64_t)wk.x * c;    // one IMAD.WIDE.U32 a component
      acc[1][p] += (uint64_t)wk.y * c;
      acc[2][p] += (uint64_t)wk.z * c;
      acc[3][p] += (uint64_t)wk.w * c;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < V; ++p) acc[q][p] = fold(acc[q][p]);
}

// the slice's constraints [lo, hi) (slice-relative) of group G: four a step
template <int G, typename Off, int V>
__device__ __forceinline__ void group_terms(const uint32_t* __restrict__ vx, Off M,
                                            uint32_t (*rows)[kSliceMax],
                                            const uint4* __restrict__ w, int lo, int hi,
                                            uint64_t acc[4][V]) {
  int j = lo;
  for (; j + 4 <= hi; j += 4) group_step<G, 4, Off, V>(vx, M, rows, w, j, acc);
  for (; j < hi; ++j) group_step<G, 1, Off, V>(vx, M, rows, w, j, acc);
}

// grid (point tiles, slices of `slice` <= kSliceMax constraints); thread
// handles points [x, x + V); partial[(slice * 4 + q) * M + x]. The block
// first copies its slice's index fields and weights to shared memory.
template <typename Off, int V>
__global__ void __launch_bounds__(kStarkThreads)
    composition_kernel(const uint32_t* __restrict__ vals, long long M, Groups gr,
                       const uint32_t* __restrict__ weights, int slice,
                       uint32_t* __restrict__ partial) {
  __shared__ uint32_t rows[kMaxFields][kSliceMax];
  __shared__ uint4 w[kSliceMax];
  long long total = 0;
  for (int g = 0; g < kGroups; ++g) total += gr.n[g];
  const long long k0 = (long long)blockIdx.y * slice;
  const int cnt = (int)(total - k0 < slice ? total - k0 : slice);
  for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
    long long i = k0 + j;
    int g = 0;
    while (i >= gr.n[g]) i -= gr.n[g++];
    const int32_t* ix = gr.idx + gr.off[g] + i;
    for (int f = 0; f < group_fields(g); ++f) {
      const uint32_t r = (uint32_t)ix[f * gr.n[g]];
      rows[f][j] = sizeof(Off) == 4 ? r * (uint32_t)M : r;
    }
    w[j] = reinterpret_cast<const uint4*>(weights)[k0 + j];
  }
  __syncthreads();
  const long long x = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (x >= M) return;
  uint64_t acc[4][V] = {};
  int lo = 0;
  long long start = 0;                    // first constraint of the group
#define ZK_GROUP(G)                                                                     \
  {                                                                                     \
    const long long a = start > k0 ? start - k0 : 0;                                    \
    const long long e = start + gr.n[G] - k0;                                           \
    const int hi = (int)(e < cnt ? (e > 0 ? e : 0) : cnt);                              \
    lo = (int)(a < hi ? a : hi);                                                        \
    group_terms<G, Off, V>(vals + x, (Off)M, rows, w, lo, hi, acc);                     \
    start += gr.n[G];                                                                   \
  }
  ZK_GROUP(0) ZK_GROUP(1) ZK_GROUP(2) ZK_GROUP(3) ZK_GROUP(4)
#undef ZK_GROUP
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t* o = partial + ((long long)blockIdx.y * 4 + q) * M + x;
#pragma unroll
    for (int p = 0; p < V; ++p) o[p] = m31_red(acc[q][p]);
  }
}

constexpr int kFinishRows = 32;         // slice partials a finishing block sums at once

// out[g] = (sum over slices s of partial[s * 4M + g]) * vn_inv[g mod M] for
// g < 4M: block (32 outputs) x (kFinishRows slice rows), each thread summing
// every kFinishRows-th slice, then the rows added in shared memory.
__global__ void __launch_bounds__(32 * kFinishRows)
    composition_finish_kernel(const uint32_t* __restrict__ partial, long long M,
                              long long n_slices, const uint32_t* __restrict__ vn_inv,
                              uint32_t* __restrict__ out) {
  __shared__ uint64_t sums[kFinishRows][32];
  const long long g = (long long)blockIdx.x * 32 + threadIdx.x;
  const int r = threadIdx.y;
  uint64_t acc = 0;                       // n_slices terms < 2^31 each
  if (g < 4 * M) {
    long long s = r;
    for (; s + 3 * kFinishRows < n_slices; s += 4 * kFinishRows)
      acc += (uint64_t)partial[s * 4 * M + g] + partial[(s + kFinishRows) * 4 * M + g] +
             partial[(s + 2 * kFinishRows) * 4 * M + g] +
             partial[(s + 3 * kFinishRows) * 4 * M + g];
    for (; s < n_slices; s += kFinishRows) acc += partial[s * 4 * M + g];
  }
  sums[r][threadIdx.x] = acc;
  __syncthreads();
  if (r == 0 && g < 4 * M) {
    for (int k = 1; k < kFinishRows; ++k) acc += sums[k][threadIdx.x];
    out[g] = m31_mul(m31_red(acc), vn_inv[g % M]);
  }
}

inline int launch_finish(const uint32_t* partial, long long M, long long n_slices,
                         const uint32_t* vn_inv, uint32_t* out, cudaStream_t st) {
  const dim3 grid((unsigned)((4 * M + 31) / 32)), block(32, kFinishRows);
  composition_finish_kernel<<<grid, block, 0, st>>>(partial, M, n_slices, vn_inv, out);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K7d

constexpr int kAesKinds = 9;        // bool const xor mix lookup table cum cumlk eq
constexpr int kAesHdr = 32;         // ints of a slice's header (aes_slice_table)
constexpr int kAesRowsMax = 512;    // rows a slice stages, at most
constexpr int kAesWeightsMax = 512; // weight rows a slice stages, at most

struct AesChallenges {
  uint32_t z[4], a[4];              // LogUp challenges z, alpha (QM31 components)
};

// QM31 product, components (a + b i) + (c + d i) u with u^2 = 2 + i
__device__ __forceinline__ void qm31_mul(const uint32_t a[4], const uint32_t b[4],
                                         uint32_t out[4]) {
  const uint32_t c0 = m31_sub(m31_mulc(a[0], b[0]), m31_mulc(a[1], b[1]));
  const uint32_t c1 = m31_add(m31_mulc(a[0], b[1]), m31_mulc(a[1], b[0]));
  const uint32_t d0 = m31_sub(m31_mulc(a[2], b[2]), m31_mulc(a[3], b[3]));
  const uint32_t d1 = m31_add(m31_mulc(a[2], b[3]), m31_mulc(a[3], b[2]));
  const uint32_t e0 = m31_sub(m31_add(d0, d0), d1);          // (2 + i) d
  const uint32_t e1 = m31_add(d0, m31_add(d1, d1));
  out[0] = m31_add(c0, e0);
  out[1] = m31_add(c1, e1);
  out[2] = m31_add(m31_sub(m31_mulc(a[0], b[2]), m31_mulc(a[1], b[3])),
                   m31_sub(m31_mulc(a[2], b[0]), m31_mulc(a[3], b[1])));
  out[3] = m31_add(m31_add(m31_mulc(a[0], b[3]), m31_mulc(a[1], b[2])),
                   m31_add(m31_mulc(a[2], b[1]), m31_mulc(a[3], b[0])));
}

// z - (u + alpha v), u and v in M31
__device__ __forceinline__ void logup_den(const AesChallenges& ch, uint32_t u, uint32_t v,
                                          uint32_t d[4]) {
  d[0] = m31_sub(ch.z[0], m31_add(u, m31_mulc(ch.a[0], v)));
#pragma unroll
  for (int c = 1; c < 4; ++c) d[c] = m31_sub(ch.z[c], m31_mulc(ch.a[c], v));
}

// Where a K7d thread reads: its V points x.. at vx = vals + x, sigma of
// each at sx[k]; rows are staged offsets (row_offset)
template <typename Off, int V>
struct AesPts {
  const uint32_t* __restrict__ vals;
  const uint32_t* __restrict__ vx;
  Off M;
  uint32_t sx[V];
  __device__ __forceinline__ void at(uint32_t r, uint32_t* v) const {
    load_points<V>(vx + row_offset<Off>(r, M), v);
  }
  __device__ __forceinline__ void sh(uint32_t r, uint32_t* v) const {
    const uint32_t* p = vals + row_offset<Off>(r, M);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = p[sx[k]];
  }
};

template <int V>
__device__ __forceinline__ void fold_all(uint64_t acc[4][V]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int p = 0; p < V; ++p) acc[q][p] = fold(acc[q][p]);
}

// acc[q][p] += w.q * c[p], one IMAD.WIDE.U32 a component and point
template <int V>
__device__ __forceinline__ void add_terms(uint64_t acc[4][V], uint4 w, const uint32_t* c) {
#pragma unroll
  for (int p = 0; p < V; ++p) {
    acc[0][p] += (uint64_t)w.x * c[p];
    acc[1][p] += (uint64_t)w.y * c[p];
    acc[2][p] += (uint64_t)w.z * c[p];
    acc[3][p] += (uint64_t)w.w * c[p];
  }
}

__host__ __device__ constexpr int aes_fields(int kind) {
  return kind == 0 || kind == 1 ? 1 : kind == 2 || kind == 8 ? 3 : kind == 3 ? 13 : 0;
}

// c(x) of a one-constraint item from its gathered values f (s: the row at
// sigma x, for const)
template <int KIND>
__device__ __forceinline__ uint32_t aes_constraint(const uint32_t* f, uint32_t s) {
  constexpr uint64_t P = kP31;
  if (KIND == 0) return m31_mulc(f[0], kP31 + 1 - f[0]);  // bool: b (1 - b)
  if (KIND == 1) return m31_sub(s, f[0]); // const: v(sigma x) - v(x)
  if (KIND == 2) {                        // xor: R + 2AB - (A + B)
    const uint64_t a = f[0], b = f[1];
    return m31_red(f[2] + 2 * (uint64_t)m31_mulc(f[0], f[1]) + 2 * P - a - b);
  }
  if (KIND == 3) {                        // mix: sum T - (R + 2 K0 + 4 K1 + 8 K2)
    uint64_t t = 16 * P;                  // dec < 15 p
#pragma unroll
    for (int k = 0; k < 9; ++k) t += f[k];
    return m31_red(t - f[9] - 2ull * f[10] - 4ull * f[11] - 8ull * f[12]);
  }
  const uint64_t ks = f[0], pt = f[1];    // eq: KS + PT - (2 KS PT + CT)
  return m31_red(ks + pt + 3 * P - 2 * (uint64_t)m31_mulc(f[0], f[1]) - f[2]);
}

// U one-constraint items j.. of a kind: every gather in flight, then the
// terms, then one fold (U <= 4 terms)
template <int KIND, int U, typename Off, int V>
__device__ __forceinline__ void simple_step(const AesPts<Off, V>& pt, const uint32_t* rows,
                                            int cnt, const uint4* w, int j,
                                            uint64_t acc[4][V]) {
  constexpr int F = aes_fields(KIND);
  uint32_t v[U][F][V], s[U][V];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int f = 0; f < F; ++f) pt.at(rows[f * cnt + j + u], v[u][f]);
    if (KIND == 1) pt.sh(rows[j + u], s[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    uint32_t c[V];
#pragma unroll
    for (int p = 0; p < V; ++p) {
      uint32_t fv[F];
#pragma unroll
      for (int f = 0; f < F; ++f) fv[f] = v[u][f][p];
      c[p] = aes_constraint<KIND>(fv, KIND == 1 ? s[u][p] : 0u);
    }
    add_terms<V>(acc, w[j + u], c);
  }
  fold_all<V>(acc);
}

template <int KIND, int U, typename Off, int V>
__device__ __forceinline__ void simple_items(const AesPts<Off, V>& pt, const uint32_t* rows,
                                             int cnt, const uint4* w, uint64_t acc[4][V]) {
  int j = 0;
  for (; j + U <= cnt; j += U) simple_step<KIND, U, Off, V>(pt, rows, cnt, w, j, acc);
  for (; j < cnt; ++j) simple_step<KIND, 1, Off, V>(pt, rows, cnt, w, j, acc);
}

// lookup j: f_j (z - (u + alpha v)) - 1, four constraints with weight rows
// 4j + c; fields U0-7, V0-7, F0-3
template <typename Off, int V>
__device__ __forceinline__ void lookup_items(const AesPts<Off, V>& pt, const AesChallenges& ch,
                                             const uint32_t* rows, int cnt, const uint4* w,
                                             uint64_t acc[4][V]) {
  for (int j = 0; j < cnt; ++j) {
    uint32_t v[20][V];
#pragma unroll
    for (int f = 0; f < 20; ++f) pt.at(rows[f * cnt + j], v[f]);
    uint32_t prod[4][V];
#pragma unroll
    for (int p = 0; p < V; ++p) {
      uint64_t u = 0, vv = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        u += (uint64_t)v[b][p] << b;
        vv += (uint64_t)v[8 + b][p] << b;
      }
      uint32_t den[4], f[4], r[4];
      logup_den(ch, m31_red(u), m31_red(vv), den);
#pragma unroll
      for (int c = 0; c < 4; ++c) f[c] = v[16 + c][p];
      qm31_mul(f, den, r);
      r[0] = m31_sub(r[0], 1);
#pragma unroll
      for (int c = 0; c < 4; ++c) prod[c][p] = r[c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) add_terms<V>(acc, w[4 * j + c], prod[c]);
    fold_all<V>(acc);
  }
}

// the table: g (z - (tval + alpha sval)) - m tact; fields TVAL, SVAL, G0-3,
// MULT, TACT
template <typename Off, int V>
__device__ __forceinline__ void table_item(const AesPts<Off, V>& pt, const AesChallenges& ch,
                                           const uint32_t* rows, const uint4* w,
                                           uint64_t acc[4][V]) {
  uint32_t v[8][V], prod[4][V];
#pragma unroll
  for (int f = 0; f < 8; ++f) pt.at(rows[f], v[f]);
#pragma unroll
  for (int p = 0; p < V; ++p) {
    uint32_t den[4], g[4], r[4];
    logup_den(ch, v[0][p], v[1][p], den);
#pragma unroll
    for (int c = 0; c < 4; ++c) g[c] = v[2 + c][p];
    qm31_mul(g, den, r);
    r[0] = m31_sub(r[0], m31_mulc(v[6][p], v[7][p]));
#pragma unroll
    for (int c = 0; c < 4; ++c) prod[c][p] = r[c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) add_terms<V>(acc, w[c], prod[c]);
  fold_all<V>(acc);
}

// the cum column's constraint cum(sx) - cum(x) - (sum_j f_j - g)(sx), split
// (it is linear): the cum item adds cum(sx) - cum(x) + g(sx) (fields cum0-3,
// G0-3), each cumlk item j adds -f_j(sx) (fields F0-3 of lookup j), all
// with the cum column's four weight rows. A slice sums its cumlk items'
// values first (< 2^31 each, at most kAesRowsMax / 4 of them), then adds
// four terms.
template <typename Off, int V>
__device__ __forceinline__ void cum_item(const AesPts<Off, V>& pt, const uint32_t* rows,
                                         const uint4* w, uint64_t acc[4][V]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t cs[V], cx[V], gs[V], t[V];
    pt.sh(rows[c], cs);
    pt.at(rows[c], cx);
    pt.sh(rows[4 + c], gs);
#pragma unroll
    for (int p = 0; p < V; ++p) t[p] = m31_add(m31_sub(cs[p], cx[p]), gs[p]);
    add_terms<V>(acc, w[c], t);
  }
  fold_all<V>(acc);
}

template <typename Off, int V>
__device__ __forceinline__ void cumlk_items(const AesPts<Off, V>& pt, const uint32_t* rows,
                                            int cnt, const uint4* w, uint64_t acc[4][V]) {
  if (cnt == 0) return;
  uint64_t sum[4][V] = {};
  int j = 0;
  for (; j + 4 <= cnt; j += 4) {          // sixteen gathers a point in flight
    uint32_t v[4][4][V];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) pt.sh(rows[c * cnt + j + u], v[u][c]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int p = 0; p < V; ++p) sum[c][p] += v[u][c][p];
  }
  for (; j < cnt; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t v[V];
      pt.sh(rows[c * cnt + j], v);
#pragma unroll
      for (int p = 0; p < V; ++p) sum[c][p] += v[p];
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t t[V];
#pragma unroll
    for (int p = 0; p < V; ++p) t[p] = m31_sub(0u, m31_red(sum[c][p]));
    add_terms<V>(acc, w[c], t);
  }
  fold_all<V>(acc);
}

// grid (slices, point tiles) when slices_first, else (point tiles, slices).
// Slice s's header hdr[s * kAesHdr ..]: its rows at srows[h0, h0 + h1),
// its weight rows [h2, h2 + h3); then for kind k (kAesKinds, alpha-power
// order) its item count, the offset of its rows (field f of item j at
// rows[off + f * count + j]) and of its weight rows in the slice's. The
// block stages the rows (times M when Off is 32-bit) and the weight rows in
// shared memory. A thread takes V neighbouring points x.. (16- or 8-byte
// gathers at x; one value a point at sigma x); partial[(slice * 4 + q) * M
// + x], summed by composition_finish_kernel. (The launch bounds name one
// block an SM: without a minimum, ptxas held the 64-bit-offset two-point
// instance to 64 registers and spilled; the four-point instance the AES
// shapes run keeps three blocks an SM either way.)
template <typename Off, int V>
__global__ void __launch_bounds__(kStarkThreads, 1)
    aes_composition_kernel(const uint32_t* __restrict__ vals, long long M,
                           const int32_t* __restrict__ perm, const __grid_constant__ AesChallenges ch,
                           const int32_t* __restrict__ hdr, const int32_t* __restrict__ srows,
                           const uint32_t* __restrict__ weights, int slices_first,
                           uint32_t* __restrict__ partial) {
  __shared__ int h[kAesHdr];
  __shared__ uint32_t rows[kAesRowsMax];
  __shared__ uint4 w[kAesWeightsMax];
  const unsigned slice = slices_first ? blockIdx.x : blockIdx.y;
  const unsigned tile = slices_first ? blockIdx.y : blockIdx.x;
  if (threadIdx.x < kAesHdr) h[threadIdx.x] = hdr[(long long)slice * kAesHdr + threadIdx.x];
  __syncthreads();
  for (int j = threadIdx.x; j < h[1]; j += blockDim.x) {
    const uint32_t r = (uint32_t)srows[h[0] + j];
    rows[j] = sizeof(Off) == 4 ? r * (uint32_t)M : r;
  }
  for (int j = threadIdx.x; j < h[3]; j += blockDim.x)
    w[j] = reinterpret_cast<const uint4*>(weights)[h[2] + j];
  __syncthreads();
  const long long x = ((long long)tile * blockDim.x + threadIdx.x) * V;
  if (x >= M) return;
  AesPts<Off, V> pt{vals, vals + x, (Off)M, {}};
#pragma unroll
  for (int k = 0; k < V; ++k) pt.sx[k] = (uint32_t)perm[x + k];
  uint64_t acc[4][V] = {};
  simple_items<0, 4, Off, V>(pt, rows + h[5], h[4], w + h[6], acc);
  simple_items<1, 4, Off, V>(pt, rows + h[8], h[7], w + h[9], acc);
  simple_items<2, 4, Off, V>(pt, rows + h[11], h[10], w + h[12], acc);
  simple_items<3, 2, Off, V>(pt, rows + h[14], h[13], w + h[15], acc);
  lookup_items<Off, V>(pt, ch, rows + h[17], h[16], w + h[18], acc);
  if (h[19]) table_item<Off, V>(pt, ch, rows + h[20], w + h[21], acc);
  if (h[22]) cum_item<Off, V>(pt, rows + h[23], w + h[24], acc);
  cumlk_items<Off, V>(pt, rows + h[26], h[25], w + h[27], acc);
  simple_items<8, 4, Off, V>(pt, rows + h[29], h[28], w + h[30], acc);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t o[V];
#pragma unroll
    for (int p = 0; p < V; ++p) o[p] = m31_red(acc[q][p]);
    store_points<V>(partial + ((long long)slice * 4 + q) * M + x, o);
  }
}

}  // namespace zksc

extern "C" {

// K7a. out: [count, 8] digest words (little-endian bytes of the digest).
int zksc_blake2s(const void* base, long long count, long long len, long long msg_stride,
                 long long word_stride, void* out, void* stream) {
  if (count <= 0) return (int)cudaSuccess;
  if (len < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(zksc::stark_grid(count)), block(zksc::kStarkThreads);
  zksc::blake2s_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)base, count, len, msg_stride, word_stride, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// K7a, one launch a tree: N (a power of two) leaves of `len` bytes, word j
// of leaf i at base[i * msg_stride + j * word_stride]; out: [2N - 1, 8]
// digest words, the layers back to back; ticket: one unsigned of scratch,
// zeroed here on the stream before the launch.
int zksc_blake2s_tree(const void* base, long long N, long long len, long long msg_stride,
                      long long word_stride, void* out, void* ticket, void* stream) {
  if (N <= 0 || (N & (N - 1)) || len < 0) return (int)cudaErrorInvalidValue;
  const int L = (int)(N < zksc::kTreeLeaves ? N : zksc::kTreeLeaves);
  if (N / L > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N > L) {                                // more than one block: a ticket
    const cudaError_t e = cudaMemsetAsync(ticket, 0, sizeof(unsigned), st);
    if (e != cudaSuccess) return (int)e;
  }
  zksc::blake2s_tree_kernel<<<dim3((unsigned)(N / L)), dim3(L), 0, st>>>(
      (const uint32_t*)base, N, L, len, msg_stride, word_stride, (uint32_t*)out,
      (unsigned*)ticket);
  return (int)cudaGetLastError();
}

// K7b. in, out: [C, 2^log_n], distinct; interp: 1 interpolate, 0 evaluate;
// rev: 1 an x-layer, 0 the y-layer; log_w: the layer's chunk width; tw:
// 2^log_w twiddles (interpolate: inverses).
int zksc_circle_layer(const void* in, void* out, long long C, int log_n, int interp, int rev,
                      int log_w, const void* tw, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (log_n < 1 || log_w < 0 || log_w > log_n - 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(zksc::stark_grid(C << (log_n - 1))), block(zksc::kStarkThreads);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* i = (const uint32_t*)in;
  uint32_t* o = (uint32_t*)out;
  const uint32_t* t = (const uint32_t*)tw;
  if (interp) {
    if (rev)
      zksc::circle_layer_kernel<true, true><<<grid, block, 0, st>>>(i, o, C, log_n, log_w, t);
    else
      zksc::circle_layer_kernel<true, false><<<grid, block, 0, st>>>(i, o, C, log_n, log_w, t);
  } else {
    if (rev)
      zksc::circle_layer_kernel<false, true><<<grid, block, 0, st>>>(i, o, C, log_n, log_w, t);
    else
      zksc::circle_layer_kernel<false, false><<<grid, block, 0, st>>>(i, o, C, log_n, log_w, t);
  }
  return (int)cudaGetLastError();
}

// K7b, one launch a transform. in: [C, K] (interpolate: K = N), out: [C,
// N], N = 2^log_n with 2 <= log_n <= 15; tw: [N] packed twiddles (see
// circle_fft_kernel).
int zksc_circle_fft(const void* in, void* out, long long C, int log_n, int K, int interp,
                    const void* tw, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (log_n < 2 || log_n > zksc::kFftMaxLog || K < 0 || K > (1 << log_n) ||
      (interp && K != (1 << log_n)))
    return (int)cudaErrorInvalidValue;
  const int N = 1 << log_n;
  const int T = N <= 1024 ? N / 4 : N <= 4096 ? 256 : N / 16 < 1024 ? N / 16 : 1024;
  int log_t = 0;
  while ((1 << log_t) < T) ++log_t;
  const int B = N / 2 / T;
  const int vec = K % 4 == 0 && ((uintptr_t)in & 15) == 0;
  const uint32_t* i = (const uint32_t*)in;
  uint32_t* o = (uint32_t*)out;
  const uint32_t* t = (const uint32_t*)tw;
  cudaStream_t st = (cudaStream_t)stream;
#define ZK_FFT(BB, TT, MAXT)                                                                 \
  if (B == BB && (TT == 0 || T == TT))                                                      \
    return interp                                                                           \
        ? zksc::launch_fft<true, BB, MAXT>(i, o, C, log_n, K, log_t, vec, t, st)            \
        : zksc::launch_fft<false, BB, MAXT>(i, o, C, log_n, K, log_t, vec, t, st);
  ZK_FFT(2, 0, 256) ZK_FFT(4, 0, 256) ZK_FFT(8, 256, 256) ZK_FFT(8, 512, 512)
  ZK_FFT(8, 1024, 1024) ZK_FFT(16, 0, 1024)
#undef ZK_FFT
  return (int)cudaErrorInvalidValue;
}

// K7c. vals: [R, M]; idx: the packed index groups (off, n: 5 entries each,
// bool/add/addx/xor/eq); weights: [sum n, 4]; slice: constraints a slice (<=
// 128); points: points a thread (1 or 2; M a multiple); threads: a block's
// threads (32 or 128); wide: 64-bit gather offsets (R * M >= 2^31);
// partial: [n_slices, 4, M] scratch, n_slices = ceil(sum n / slice); out:
// [4, M].
int zksc_composition(const void* vals, long long M, const void* idx, const long long* off,
                     const long long* n, const void* weights, long long slice, int points,
                     int threads, int wide, void* partial, const void* vn_inv, void* out,
                     void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  zksc::Groups gr;
  gr.idx = (const int32_t*)idx;
  long long total = 0;
  for (int g = 0; g < zksc::kGroups; ++g) {
    gr.off[g] = off[g];
    gr.n[g] = n[g];
    total += n[g];
  }
  if (slice <= 0 || slice > zksc::kSliceMax) return (int)cudaErrorInvalidValue;
  if ((points != 1 && points != 2 && points != 4) || M % points) return (int)cudaErrorInvalidValue;
  if (threads != 32 && threads != zksc::kStarkThreads) return (int)cudaErrorInvalidValue;
  const long long n_slices = total > 0 ? (total + slice - 1) / slice : 1;
  if (n_slices > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long tile = (long long)threads * points;
  const dim3 grid((unsigned)((M + tile - 1) / tile), (unsigned)n_slices), block(threads);
  const uint32_t* v = (const uint32_t*)vals;
  const uint32_t* w = (const uint32_t*)weights;
  uint32_t* p = (uint32_t*)partial;
  const int s = (int)slice;
  if (wide) {
    if (points == 4)
      zksc::composition_kernel<unsigned long long, 4><<<grid, block, 0, st>>>(v, M, gr, w, s, p);
    else if (points == 2)
      zksc::composition_kernel<unsigned long long, 2><<<grid, block, 0, st>>>(v, M, gr, w, s, p);
    else
      zksc::composition_kernel<unsigned long long, 1><<<grid, block, 0, st>>>(v, M, gr, w, s, p);
  } else {
    if (points == 4)
      zksc::composition_kernel<uint32_t, 4><<<grid, block, 0, st>>>(v, M, gr, w, s, p);
    else if (points == 2)
      zksc::composition_kernel<uint32_t, 2><<<grid, block, 0, st>>>(v, M, gr, w, s, p);
    else
      zksc::composition_kernel<uint32_t, 1><<<grid, block, 0, st>>>(v, M, gr, w, s, p);
  }
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return zksc::launch_finish(p, M, n_slices, (const uint32_t*)vn_inv, (uint32_t*)out, st);
}

// K7d. vals: [R, M]; perm: sigma as an index map [M]; za: z[4], alpha[4];
// hdr: [n_slices, kAesHdr] slice headers and srows their rows
// (ops/stark_kernels.aes_slice_table, on the device); weights: [K, 4];
// points: points a thread (1, 2 or 4; M a multiple); threads: a block's
// threads (32 or 128); wide: 64-bit gather offsets (R * M >= 2^31);
// slices_first: consecutive blocks take the slices of one point tile;
// partial: [n_slices, 4, M] scratch; out: [4, M].
int zksc_aes_composition(const void* vals, long long M, const void* perm, const unsigned* za,
                         const void* hdr, const void* srows, long long n_slices,
                         const void* weights, int points, int threads, int wide,
                         int slices_first, void* partial, const void* vn_inv, void* out,
                         void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  if (n_slices <= 0 || n_slices > 65535) return (int)cudaErrorInvalidValue;
  if ((points != 1 && points != 2 && points != 4) || M % points) return (int)cudaErrorInvalidValue;
  if (threads != 32 && threads != zksc::kStarkThreads) return (int)cudaErrorInvalidValue;
  zksc::AesChallenges ch;
  for (int c = 0; c < 4; ++c) {
    ch.z[c] = za[c];
    ch.a[c] = za[4 + c];
  }
  const long long tile = (long long)threads * points;
  const long long tiles = (M + tile - 1) / tile;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid = slices_first ? dim3((unsigned)n_slices, (unsigned)tiles)
                                 : dim3((unsigned)tiles, (unsigned)n_slices);
  const dim3 block(threads);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* v = (const uint32_t*)vals;
  const int32_t* pm = (const int32_t*)perm;
  const int32_t* h = (const int32_t*)hdr;
  const int32_t* r = (const int32_t*)srows;
  const uint32_t* w = (const uint32_t*)weights;
  uint32_t* p = (uint32_t*)partial;
  const int sf = slices_first;
#define ZK_AES(OFF, V)                                                                      \
  zksc::aes_composition_kernel<OFF, V><<<grid, block, 0, st>>>(v, M, pm, ch, h, r, w, sf, p);
  if (wide) {
    if (points == 4) ZK_AES(unsigned long long, 4)
    else if (points == 2) ZK_AES(unsigned long long, 2)
    else ZK_AES(unsigned long long, 1)
  } else {
    if (points == 4) ZK_AES(uint32_t, 4)
    else if (points == 2) ZK_AES(uint32_t, 2)
    else ZK_AES(uint32_t, 1)
  }
#undef ZK_AES
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return zksc::launch_finish(p, M, n_slices, (const uint32_t*)vn_inv, (uint32_t*)out, st);
}

}  // extern "C"

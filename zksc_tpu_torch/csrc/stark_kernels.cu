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
// K7b circle_layer -- zksc_tpu/stark/circle.py:CircleFFT.interpolate /
//    evaluate: one fold layer of the circle FFT over a batch of C columns of
//    N values (the y-fold or an x-fold through pi(x) = 2x^2 - 1), one thread
//    per butterfly, reading and writing the batch in device memory; one
//    launch per layer. Bound: bytes (each layer reads and writes the batch).
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
//    weights base + 4j + c), the table's four constraints or the cum
//    column's four. Item kinds in alpha-power order: bool | const | xor |
//    mix | lookup | table | cum | eq. The grid is point tiles x slices of
//    consecutive items; the wrapper cuts the slices so that each gathers
//    about the same number of values. The sigma-shifted values (const and
//    cum) are read as vals[row, perm[x]] in place, not from a shifted copy
//    of vals. The cum item forms sum_j F_j(sigma x) over every lookup
//    instance itself, so the sum is formed once per point in whichever
//    slice holds that item. The summing launch is K7c's. Bound: the gathered
//    values (~30.5k a point for AES-128) or, if they all hit the caches, the
//    integer operations.
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

constexpr int kAesGroups = 6;    // packed fields: bool, const, xor, mix, lookup, eq

struct AesAir {
  const int32_t* idx;            // group g's field f of item i at
  long long off[kAesGroups];     //   idx[off[g] + f * n[g] + i]; fields:
  long long n[kAesGroups];       //   bool 1, const 1, xor A B R, mix T0-8 R
                                 //   K0 K1 K2, lookup U0-7 V0-7 F0-3, eq KS PT CT
  int32_t mult, tval, sval, tact;  // the table's rows
  int32_t g[4], cum[4];            // the table fraction's and cum's rows
  uint32_t z[4], a[4];             // LogUp challenges z, alpha (QM31 components)
};

struct AesPoint {
  const uint32_t* __restrict__ vals;
  long long M, x, sx;            // the point and sigma(x)
  const AesAir* air;
  const uint32_t* __restrict__ weights;
  __device__ __forceinline__ int32_t ref(int g, int f, long long i) const {
    return air->idx[air->off[g] + f * air->n[g] + i];
  }
  __device__ __forceinline__ uint32_t at(int32_t row) const { return vals[row * M + x]; }
  __device__ __forceinline__ uint32_t sh(int32_t row) const { return vals[row * M + sx]; }
};

// acc[q] += w[k][q] * c, the term folded below 2^32
__device__ __forceinline__ void add_term(uint64_t acc[4], const uint32_t* __restrict__ w,
                                         uint32_t c) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint64_t t = (uint64_t)w[q] * c;
    acc[q] += (t & kP31) + (t >> 31);
  }
}

// QM31 product, components (a + b i) + (c + d i) u with u^2 = 2 + i
__device__ __forceinline__ void qm31_mul(const uint32_t a[4], const uint32_t b[4],
                                         uint32_t out[4]) {
  const uint32_t c0 = m31_sub(m31_mul(a[0], b[0]), m31_mul(a[1], b[1]));
  const uint32_t c1 = m31_add(m31_mul(a[0], b[1]), m31_mul(a[1], b[0]));
  const uint32_t d0 = m31_sub(m31_mul(a[2], b[2]), m31_mul(a[3], b[3]));
  const uint32_t d1 = m31_add(m31_mul(a[2], b[3]), m31_mul(a[3], b[2]));
  const uint32_t e0 = m31_sub(m31_add(d0, d0), d1);          // (2 + i) d
  const uint32_t e1 = m31_add(d0, m31_add(d1, d1));
  out[0] = m31_add(c0, e0);
  out[1] = m31_add(c1, e1);
  out[2] = m31_add(m31_sub(m31_mul(a[0], b[2]), m31_mul(a[1], b[3])),
                   m31_sub(m31_mul(a[2], b[0]), m31_mul(a[3], b[1])));
  out[3] = m31_add(m31_add(m31_mul(a[0], b[3]), m31_mul(a[1], b[2])),
                   m31_add(m31_mul(a[2], b[1]), m31_mul(a[3], b[0])));
}

// z - (u + alpha v), u and v in M31
__device__ __forceinline__ void logup_den(const AesAir& air, uint32_t u, uint32_t v,
                                          uint32_t d[4]) {
  d[0] = m31_sub(air.z[0], m31_add(u, m31_mul(air.a[0], v)));
#pragma unroll
  for (int c = 1; c < 4; ++c) d[c] = m31_sub(air.z[c], m31_mul(air.a[c], v));
}

// the constraints of item i (of its kind) at one point, added with weights
// from w (the item's first weight row)
template <int KIND>
__device__ __forceinline__ void aes_item(const AesPoint& p, long long i,
                                         const uint32_t* __restrict__ w, uint64_t acc[4]) {
  constexpr uint64_t P = kP31;
  if (KIND == 0) {                        // bool: b (1 - b)
    const uint64_t b = p.at(p.ref(0, 0, i));
    add_term(acc, w, m31_red(b * (1 + P - b)));
  } else if (KIND == 1) {                 // const: v(sigma x) - v(x)
    const int32_t r = p.ref(1, 0, i);
    add_term(acc, w, m31_sub(p.sh(r), p.at(r)));
  } else if (KIND == 2) {                 // xor: R + 2AB - (A + B)
    const uint64_t a = p.at(p.ref(2, 0, i)), b = p.at(p.ref(2, 1, i));
    add_term(acc, w, m31_red(p.at(p.ref(2, 2, i)) + 2 * (uint64_t)m31_red(a * b) + 2 * P - a - b));
  } else if (KIND == 3) {                 // mix: sum T - (R + 2 K0 + 4 K1 + 8 K2)
    uint64_t s = 0;
#pragma unroll
    for (int f = 0; f < 9; ++f) s += p.at(p.ref(3, f, i));
    const uint64_t dec = p.at(p.ref(3, 9, i)) + 2ull * p.at(p.ref(3, 10, i)) +
                         4ull * p.at(p.ref(3, 11, i)) + 8ull * p.at(p.ref(3, 12, i));
    add_term(acc, w, m31_red(s + 16 * P - dec));   // dec < 15 p
  } else if (KIND == 4) {                 // lookup j: f_j (z - (u + alpha v)) - 1
    uint64_t u = 0, v = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      u += (uint64_t)p.at(p.ref(4, b, i)) << b;
      v += (uint64_t)p.at(p.ref(4, 8 + b, i)) << b;
    }
    uint32_t den[4], f[4], prod[4];
    logup_den(*p.air, m31_red(u), m31_red(v), den);
#pragma unroll
    for (int c = 0; c < 4; ++c) f[c] = p.at(p.ref(4, 16 + c, i));
    qm31_mul(f, den, prod);
    prod[0] = m31_sub(prod[0], 1);
#pragma unroll
    for (int c = 0; c < 4; ++c) add_term(acc, w + 4 * c, prod[c]);
  } else if (KIND == 5) {                 // table: g (z - (tval + alpha sval)) - m tact
    const AesAir& air = *p.air;
    uint32_t den[4], g[4], prod[4];
    logup_den(air, p.at(air.tval), p.at(air.sval), den);
#pragma unroll
    for (int c = 0; c < 4; ++c) g[c] = p.at(air.g[c]);
    qm31_mul(g, den, prod);
    prod[0] = m31_sub(prod[0], m31_mul(p.at(air.mult), p.at(air.tact)));
#pragma unroll
    for (int c = 0; c < 4; ++c) add_term(acc, w + 4 * c, prod[c]);
  } else if (KIND == 6) {                 // cum: cum(sx) - cum(x) - (sum_j f_j - g)(sx)
    const AesAir& air = *p.air;
    const long long n_lk = air.n[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint64_t fsum = 0;                  // n_lk terms < 2^31 each
      for (long long j = 0; j < n_lk; ++j) fsum += p.sh(p.ref(4, 16 + c, j));
      const uint32_t F = m31_sub(m31_red(fsum), p.sh(air.g[c]));
      add_term(acc, w + 4 * c, m31_sub(m31_sub(p.sh(air.cum[c]), p.at(air.cum[c])), F));
    }
  } else {                                // eq: KS + PT - (2 KS PT + CT)
    const uint64_t ks = p.at(p.ref(5, 0, i)), pt = p.at(p.ref(5, 1, i));
    add_term(acc, w, m31_red(ks + pt + 3 * P - 2 * (uint64_t)m31_red(ks * pt) - p.at(p.ref(5, 2, i))));
  }
}

// items [start, start + count) of one kind, cut to the slice [i0, i1);
// `width` constraints (weight rows) an item, the first at row wbase
template <int KIND>
__device__ __forceinline__ void aes_items(const AesPoint& p, long long start, long long count,
                                          long long wbase, int width, long long i0, long long i1,
                                          uint64_t acc[4]) {
  const long long lo = i0 > start ? i0 : start;
  const long long hi = i1 < start + count ? i1 : start + count;
  for (long long i = lo; i < hi; ++i)
    aes_item<KIND>(p, i - start, p.weights + 4 * (wbase + width * (i - start)), acc);
}

// grid (point tiles, slices); slice s holds items [bounds[s], bounds[s + 1]);
// partial[(slice * 4 + q) * M + x], summed by composition_finish_kernel
__global__ void __launch_bounds__(kStarkThreads)
    aes_composition_kernel(const uint32_t* __restrict__ vals, long long M,
                           const int32_t* __restrict__ perm, AesAir air,
                           const long long* __restrict__ bounds,
                           const uint32_t* __restrict__ weights, uint32_t* __restrict__ partial) {
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= M) return;
  const AesPoint p{vals, M, x, (long long)perm[x], &air, weights};
  const long long i0 = bounds[blockIdx.y], i1 = bounds[blockIdx.y + 1];
  uint64_t acc[4] = {0, 0, 0, 0};
  const long long* n = air.n;
  long long s = 0, w = 0;                 // first item and weight row of a kind
  aes_items<0>(p, s, n[0], w, 1, i0, i1, acc);
  s += n[0], w += n[0];
  aes_items<1>(p, s, n[1], w, 1, i0, i1, acc);
  s += n[1], w += n[1];
  aes_items<2>(p, s, n[2], w, 1, i0, i1, acc);
  s += n[2], w += n[2];
  aes_items<3>(p, s, n[3], w, 1, i0, i1, acc);
  s += n[3], w += n[3];
  aes_items<4>(p, s, n[4], w, 4, i0, i1, acc);
  s += n[4], w += 4 * n[4];
  aes_items<5>(p, s, 1, w, 4, i0, i1, acc);
  s += 1, w += 4;
  aes_items<6>(p, s, 1, w, 4, i0, i1, acc);
  s += 1, w += 4;
  aes_items<7>(p, s, n[5], w, 1, i0, i1, acc);
#pragma unroll
  for (int q = 0; q < 4; ++q) partial[((long long)blockIdx.y * 4 + q) * M + x] = m31_red(acc[q]);
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

// K7d. vals: [R, M]; perm: sigma as an index map [M]; idx: the packed fields
// (off, n: 6 entries each, bool/const/xor/mix/lookup/eq); rows: mult, tval,
// sval, tact, g[4], cum[4]; za: z[4], alpha[4]; bounds: [n_slices + 1] item
// bounds on the device; weights: [K, 4]; partial: [n_slices, 4, M] scratch;
// out: [4, M].
int zksc_aes_composition(const void* vals, long long M, const void* perm, const void* idx,
                         const long long* off, const long long* n, const int* rows,
                         const unsigned* za, const void* bounds, long long n_slices,
                         const void* weights, void* partial, const void* vn_inv, void* out,
                         void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  if (n_slices <= 0 || n_slices > 65535) return (int)cudaErrorInvalidValue;
  zksc::AesAir air;
  air.idx = (const int32_t*)idx;
  for (int g = 0; g < zksc::kAesGroups; ++g) {
    air.off[g] = off[g];
    air.n[g] = n[g];
  }
  air.mult = rows[0], air.tval = rows[1], air.sval = rows[2], air.tact = rows[3];
  for (int c = 0; c < 4; ++c) {
    air.g[c] = rows[4 + c];
    air.cum[c] = rows[8 + c];
    air.z[c] = za[c];
    air.a[c] = za[4 + c];
  }
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((M + zksc::kStarkThreads - 1) / zksc::kStarkThreads),
                  (unsigned)n_slices);
  const dim3 block(zksc::kStarkThreads);
  zksc::aes_composition_kernel<<<grid, block, 0, st>>>(
      (const uint32_t*)vals, M, (const int32_t*)perm, air, (const long long*)bounds,
      (const uint32_t*)weights, (uint32_t*)partial);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return zksc::launch_finish((const uint32_t*)partial, M, n_slices, (const uint32_t*)vn_inv,
                             (uint32_t*)out, st);
}

}  // extern "C"

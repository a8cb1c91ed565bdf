// Hand-written Hopper (sm_90a) kernels for the Circle-STARK engine ("stark").
//
// No Pallas kernel lies on this path: in the JAX package XLA fuses the circle
// FFT and the composition and the Merkle leaves are hashed by hashlib. PyTorch
// eager fuses nothing (a Blake2s compression is ~1,100 eager ops, the
// composition's temporaries would be 0.4-0.9 GB each), so the port writes:
//
// K7a blake2s -- zksc_tpu/stark/blake2s.py:blake2s / blake2s_pair: Blake2s-256
//    (RFC 7693) of `count` messages of one byte length, one thread per
//    message, the state in registers and each message word read once. The
//    source is strided: word j of message i is base[i * msg_stride + j *
//    word_stride], so the trace commitment hashes the columns of the [C, M]
//    LDE in place (msg_stride 1, word_stride M: a warp's threads read
//    neighbouring words) and a Merkle node layer reads cur[2i] || cur[2i+1]
//    (msg_stride 16) with no concatenation. Bound: integer operations (~1,120
//    a compression) or the bytes read, whichever is larger; a leaf's blocks
//    chain, so a launch has only as many threads as messages (1,024-2,048 for
//    a trace commitment), and the next block's words are loaded while the
//    current one is compressed.
// K7b circle_layer -- zksc_tpu/stark/circle.py:CircleFFT.interpolate /
//    evaluate: one fold layer of the circle FFT over a batch of C columns of
//    N values (the y-fold or an x-fold through pi(x) = 2x^2 - 1), one thread
//    per butterfly, reading and writing the batch in device memory; one
//    launch per layer. Bound: bytes (each layer reads and writes the batch).
// K7c composition -- zksc_tpu/stark/prover.py:_composition: for every LDE
//    point x, sum_k w_k * c_k(x) over the AIR's constraints (bool, add, addx,
//    xor, eq, in that order) with QM31 weights w_k, then times V_N(x)^-1. A
//    2-D grid of point tiles x constraint slices: each thread gathers
//    vals[row, x] (x contiguous across the warp, so the gathers are
//    coalesced) and keeps four partial sums for its point over its slice;
//    a second launch adds the slices' partials and multiplies by vn_inv.
//    Addition mod p is exact, so any summation order gives the reference's
//    values. Bound: the gathered bytes.
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

// Message i: `len` bytes, little-endian in the words src[j * ws], src =
// base + i * ms. Every block but the last is full; the last block holds
// the rest of the message, zero-padded (bytes past `len` of its last word
// are masked), and t counts bytes, as RFC 7693 has it. An empty message is
// one zero block with t = 0.
__global__ void __launch_bounds__(kStarkThreads)
    blake2s_kernel(const uint32_t* __restrict__ base, long long count, long long len,
                   long long ms, long long ws, uint32_t* __restrict__ out) {
  const long long n_blocks = len > 0 ? (len + 63) / 64 : 1;
  const long long n_words = (len + 3) / 4;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    const uint32_t* src = base + i * ms;
    uint32_t h[8] = {0x6A09E667u ^ 0x01010020u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                     0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
    uint32_t m[16], nxt[16];
    if (n_blocks > 1) {
#pragma unroll
      for (int j = 0; j < 16; ++j) nxt[j] = src[j * ws];
    }
    for (long long blk = 0; blk + 1 < n_blocks; ++blk) {
#pragma unroll
      for (int j = 0; j < 16; ++j) m[j] = nxt[j];
      if (blk + 2 < n_blocks) {               // the next full block, in flight
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
        const long long tail = len - 4 * w;   // bytes of this word in the message
        if (tail < 4) x &= (1u << (8 * tail)) - 1u;
      }
      m[j] = x;
    }
    blake2s_compress(h, m, (unsigned long long)len, true);
#pragma unroll
    for (int k = 0; k < 8; ++k) out[i * 8 + k] = h[k];
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

constexpr int kGroups = 5;   // bool, add, addx, xor, eq

struct Groups {
  const int32_t* idx;        // packed: group g's field f of constraint i at
  long long off[kGroups];    //   idx[off[g] + f * n[g] + i]
  long long n[kGroups];
};

// c_k(x) of constraint i of group G, from the gathered rows (all canonical)
template <int G>
__device__ __forceinline__ uint32_t constraint(const uint32_t* __restrict__ vals, long long M,
                                               long long x, const Groups& gr, long long i) {
  const int32_t* ix = gr.idx + gr.off[G] + i;
  const long long n = gr.n[G];
  auto at = [&](int f) -> uint64_t { return vals[(long long)ix[f * n] * M + x]; };
  constexpr uint64_t P = kP31;
  if (G == 0) {                           // b (1 - b)
    const uint64_t b = at(0);
    return m31_red(b * (1 + P - b));
  }
  if (G == 1) {                           // R + 2C - (A + B + Cin)
    return m31_red(at(2) + 2 * at(3) + 3 * P - at(0) - at(1) - at(4));
  }
  if (G == 2) {                           // R + 2C - ((U + W - 2UW) + B + Cin)
    const uint64_t u = at(0), w = at(1);
    const uint64_t uw = m31_red(u * w);
    return m31_red(at(3) + 2 * at(4) + 2 * uw + 4 * P - u - w - at(2) - at(5));
  }
  if (G == 3) {                           // R + 2AB - (A + B)
    const uint64_t a = at(0), b = at(1);
    return m31_red(at(2) + 2 * (uint64_t)m31_red(a * b) + 2 * P - a - b);
  }
  const uint64_t ks = at(0), pt = at(1);  // KS + PT - (2 KS PT + CT)
  return m31_red(ks + pt + 3 * P - 2 * (uint64_t)m31_red(ks * pt) - at(2));
}

template <int G>
__device__ __forceinline__ void accumulate(const uint32_t* __restrict__ vals, long long M,
                                           long long x, const Groups& gr, long long start,
                                           long long k0, long long k1,
                                           const uint32_t* __restrict__ weights,
                                           uint64_t acc[4]) {
  const long long lo = k0 > start ? k0 : start;
  const long long end = start + gr.n[G];
  const long long hi = k1 < end ? k1 : end;
  for (long long k = lo; k < hi; ++k) {
    const uint64_t c = constraint<G>(vals, M, x, gr, k - start);
    const uint32_t* w = weights + 4 * k;
#pragma unroll
    for (int q = 0; q < 4; ++q) {       // each term folded below 2^32
      const uint64_t t = (uint64_t)w[q] * c;
      acc[q] += (t & kP31) + (t >> 31);
    }
  }
}

// grid (point tiles, slices): partial[(slice * 4 + q) * M + x]
__global__ void __launch_bounds__(kStarkThreads)
    composition_kernel(const uint32_t* __restrict__ vals, long long M, Groups gr,
                       const uint32_t* __restrict__ weights, long long slice,
                       uint32_t* __restrict__ partial) {
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= M) return;
  const long long k0 = (long long)blockIdx.y * slice, k1 = k0 + slice;
  uint64_t acc[4] = {0, 0, 0, 0};
  long long s = 0;
  accumulate<0>(vals, M, x, gr, s, k0, k1, weights, acc);
  s += gr.n[0];
  accumulate<1>(vals, M, x, gr, s, k0, k1, weights, acc);
  s += gr.n[1];
  accumulate<2>(vals, M, x, gr, s, k0, k1, weights, acc);
  s += gr.n[2];
  accumulate<3>(vals, M, x, gr, s, k0, k1, weights, acc);
  s += gr.n[3];
  accumulate<4>(vals, M, x, gr, s, k0, k1, weights, acc);
#pragma unroll
  for (int q = 0; q < 4; ++q) partial[((long long)blockIdx.y * 4 + q) * M + x] = m31_red(acc[q]);
}

// out[q * M + x] = (sum over slices of partial) * vn_inv[x]
__global__ void __launch_bounds__(kStarkThreads)
    composition_finish_kernel(const uint32_t* __restrict__ partial, long long M,
                              long long n_slices, const uint32_t* __restrict__ vn_inv,
                              uint32_t* __restrict__ out) {
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < 4 * M;
       g += (long long)gridDim.x * blockDim.x) {
    const long long q = g / M, x = g - q * M;
    uint64_t acc = 0;                   // n_slices terms < 2^31 each
    for (long long s = 0; s < n_slices; ++s) acc += partial[(s * 4 + q) * M + x];
    out[g] = m31_mul(m31_red(acc), vn_inv[x]);
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
// bool/add/addx/xor/eq); weights: [sum n, 4]; partial: [n_slices, 4, M]
// scratch, n_slices = ceil(sum n / slice); out: [4, M].
int zksc_composition(const void* vals, long long M, const void* idx, const long long* off,
                     const long long* n, const void* weights, long long slice, void* partial,
                     const void* vn_inv, void* out, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  zksc::Groups gr;
  gr.idx = (const int32_t*)idx;
  long long total = 0;
  for (int g = 0; g < zksc::kGroups; ++g) {
    gr.off[g] = off[g];
    gr.n[g] = n[g];
    total += n[g];
  }
  if (slice <= 0) return (int)cudaErrorInvalidValue;
  const long long n_slices = total > 0 ? (total + slice - 1) / slice : 1;
  if (n_slices > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((M + zksc::kStarkThreads - 1) / zksc::kStarkThreads),
                  (unsigned)n_slices);
  const dim3 block(zksc::kStarkThreads);
  zksc::composition_kernel<<<grid, block, 0, st>>>((const uint32_t*)vals, M, gr,
                                                   (const uint32_t*)weights, slice,
                                                   (uint32_t*)partial);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const dim3 grid2(zksc::stark_grid(4 * M));
  zksc::composition_finish_kernel<<<grid2, block, 0, st>>>(
      (const uint32_t*)partial, M, n_slices, (const uint32_t*)vn_inv, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

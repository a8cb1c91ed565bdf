// Hand-written Hopper (sm_90a) kernels for the Groth16 quotient H(x) over
// BN254 Fr. The reference has no Pallas kernel here: its H pass is plain
// jnp that XLA compiles into a few fused programs (groth16/prove.py:
// _h_pipeline_batch is jitted, as are ops/ntt.py's transforms and
// fields/limb.py's mont_mul). PyTorch eager does not fuse, and ran the same
// pass as ~40K launches of int64 limb operations, so the port writes it by
// hand:
//
// K0 fr_elementwise -- replaces the Fr.mont_mul / Fr.sub of
//    zksc_tpu/groth16/prove.py:_h_core (h = (a b - c) / Z_H on the coset,
//    one pass) and the Fr.to_mont of _witnesses_to_device: out = a k or
//    out = (a b - c) k for a constant k, one element a thread.
// K5 sparse_matvec -- replaces zksc_tpu/groth16/prove.py:_matvec: <M, z>
//    per constraint row, the A, B and C matrices stacked as one CSR matrix
//    of M n rows, one (row, proof) a thread: a modular sum of Montgomery
//    products z_col c. The reference's lazy segment sum, its carry
//    normalisation, mont_reduce_wide and to_mont give the canonical sum
//    mod r too. Rows past the last constraint are empty: zero.
// K4 ntt_group -- replaces zksc_tpu/ops/ntt.py:dif_inverse, dit_forward,
//    coset_evals_from_coeffs_br and coeffs_br_from_coset_evals: a group of
//    consecutive radix-2 stages of the same bit-reversal-free DIF / DIT
//    transforms in shared memory, then or before them the product by one
//    table (the 1/n scale, the coset shift powers, from_mont folded in by
//    the caller), over every row of a [16, rows, n] array. A transform of
//    n = 2^16-2^18 elements (32 B each) does not fit one block's 227 KB, so
//    the wrapper (ops/h_kernels.py:ntt_plan) cuts its log n stages into
//    groups of at most log E: the group of the smallest spans reads a
//    contiguous chunk of E elements; a group of larger spans (half-spans
//    G .. G 2^(ns - 1)) fixes T consecutive low indices and loads the 2^ns
//    indices G apart above each, so every butterfly's partner is in the
//    tile and each limb row is read in runs of T words. DIF runs the
//    groups from the largest spans down, DIT from the smallest up; the DIF
//    of a coset pass and the DIT that follows share the group of the
//    smallest spans, which runs both in one launch. Twiddles come from one
//    table of powers w^e (e < n / 2) a direction, indexed by stride.
//
// Tensor layout at the boundary: 16 x 16-bit limbs per element, limb-major
// int32 arrays (fields/limb.py), element i's limb k at ptr[k * ld + i];
// inside, two limbs a 32-bit word (bn254.cuh). Tables and the mat-vec's
// coefficients are packed by the wrapper as [count, 8] words, one 32-byte
// element a row (two 16-byte loads).
//
// What bounds them on this card: integer multiply-adds. One Montgomery
// product is ~258 IMAD issue slots (bn254.cuh), a butterfly one product,
// an elementwise quotient two, a mat-vec term one; the bytes (32 B an
// element in, 32 B out, the mat-vec's 16 scattered 4-byte gathers of z and
// a 32-byte coefficient a term) come second. What the design does about
// it: each element stays in registers or shared memory between its
// products, so an NTT group reads and writes each element once; the
// product is bn254.cuh's inlined carry-chain CIOS over Fr; a whole pass is
// a few launches instead of tens of thousands.
#include <cuda_runtime.h>

#include <cstdint>

#include "bn254.cuh"

namespace zksc {

constexpr int kHThreads = 128;      // K0, K5: one element or (row, proof) a thread
constexpr int kNttThreads = 256;    // K4: butterflies of a tile
constexpr int kNttMaxLogTile = 12;  // 4,096 elements, 128 KB of shared memory

// element i of a packed [count, 8]-word table
__device__ __forceinline__ Fr load_words(const uint32_t* t, size_t i) {
  const uint4* q = reinterpret_cast<const uint4*>(t + 8 * i);
  const uint4 a = q[0], b = q[1];
  Fr r;
  r.w[0] = a.x; r.w[1] = a.y; r.w[2] = a.z; r.w[3] = a.w;
  r.w[4] = b.x; r.w[5] = b.y; r.w[6] = b.z; r.w[7] = b.w;
  return r;
}

// K0 -- QUOTIENT false: out = a k; true: out = (a b - c) k, with b and c
// at a + N and a + 2N (the three [16, N] parts of one [16, 3, N] array,
// row stride in_ld). out: [16, N].
template <bool QUOTIENT>
__global__ void __launch_bounds__(kHThreads) fr_elementwise_kernel(const uint32_t* a,
                                                                   long long in_ld, Fr k,
                                                                   uint32_t* out, long long N) {
  for (size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x; g < (size_t)N;
       g += (size_t)gridDim.x * blockDim.x) {
    Fr x = load_fp<Fr>(a, g, (size_t)in_ld);
    if (QUOTIENT) {
      const Fr b = load_fp<Fr>(a + N, g, (size_t)in_ld);
      const Fr c = load_fp<Fr>(a + 2 * N, g, (size_t)in_ld);
      x = mod_sub(mont_mul(x, b), c);
    }
    store_fp(out, g, (size_t)N, mont_mul(x, k));
  }
}

// K5 -- z: [16, k, m_pad] (row stride z_ld = k m_pad); CSR rows R = m n + row
// of the M stacked matrices: entries row_ptr[R] .. row_ptr[R + 1] - 1, with
// their columns and packed Montgomery coefficients. out: [16, M, k, n],
// thread g = (m k + j) n + row, row stride total = M k n.
__global__ void __launch_bounds__(kHThreads) sparse_matvec_kernel(
    const uint32_t* z, long long z_ld, long long m_pad, const int* row_ptr, const int* cols,
    const uint32_t* coeffs, uint32_t* out, long long n, long long k, long long total) {
  for (size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x; g < (size_t)total;
       g += (size_t)gridDim.x * blockDim.x) {
    const size_t kn = (size_t)k * n;
    const size_t m = g / kn, rem = g % kn, j = rem / n, row = rem % n;
    const size_t R = m * n + row;
    const uint32_t* zj = z + j * m_pad;
    Fr acc = elem_zero<Fr>();
    for (int t = row_ptr[R]; t < row_ptr[R + 1]; ++t)
      acc = mod_add(acc, mont_mul(load_fp<Fr>(zj, (size_t)cols[t], (size_t)z_ld),
                                  load_words(coeffs, (size_t)t)));
    store_fp(out, g, (size_t)total, acc);
  }
}

// One K4 stage group of an n = 2^log_n transform: global half-spans
// 2^(top - ns + 1) .. 2^top, tiles of E = 2^(ns + tl) elements, T = 2^tl
// consecutive low indices each.
struct NttGroup {
  int log_n, top, ns, tl;
};

__device__ __forceinline__ Fr sm_get(const uint32_t* sm, int E, int e) {
  Fr r;
#pragma unroll
  for (int w = 0; w < 8; ++w) r.w[w] = sm[w * E + e];
  return r;
}

__device__ __forceinline__ void sm_put(uint32_t* sm, int E, int e, const Fr& v) {
#pragma unroll
  for (int w = 0; w < 8; ++w) sm[w * E + e] = v.w[w];
}

// K4 -- block = one tile of one row of src / dst ([16, rows, n], row stride
// ld; dst may be src). The tile sits in shared memory word-planar (word w
// of local element e at sm[w E + e]: neighbouring threads, neighbouring
// banks). DIF: the group's stages from the largest span down, (u, v) ->
// (u + v, (u - v) w^-j); then, where scale is given, the product by
// scale[i * scale_stride] (i: the position in the row); then DIT: the
// stages from the smallest span up, (u, v) -> (u + v w^j, u - v w^j).
template <bool DIF, bool DIT>
__global__ void __launch_bounds__(kNttThreads) ntt_group_kernel(
    const uint32_t* src, uint32_t* dst, long long ld, NttGroup g, const uint32_t* tw_inv,
    const uint32_t* tw_fwd, const uint32_t* scale, long long scale_stride) {
  extern __shared__ uint32_t sm[];
  const int E = 1 << (g.ns + g.tl);
  const int bot = g.top - g.ns + 1;
  const size_t n = (size_t)1 << g.log_n;
  const size_t tiles = n >> (g.ns + g.tl);
  const size_t row = blockIdx.x / tiles, q = blockIdx.x % tiles;
  const size_t per_outer = ((size_t)1 << bot) >> g.tl;    // tiles of one outer block
  const size_t first = (q / per_outer) * ((size_t)2 << g.top) + (q % per_outer) * ((size_t)1 << g.tl);
  const size_t T1 = ((size_t)1 << g.tl) - 1;
  // position in the row of local element e
  auto pos = [&](int e) { return first + ((size_t)(e >> g.tl) << bot) + ((size_t)e & T1); };
  const size_t at = row * n;

  for (int e = threadIdx.x; e < E; e += blockDim.x)
    sm_put(sm, E, e, load_fp<Fr>(src, at + pos(e), (size_t)ld));
  __syncthreads();
  if (DIF) {
    for (int s = 0; s < g.ns; ++s) {
      const int lh = g.tl + g.ns - 1 - s, gh = g.top - s;   // log2 half-spans, local / global
      for (int b = threadIdx.x; b < E / 2; b += blockDim.x) {
        const int eu = ((b >> lh) << (lh + 1)) | (b & ((1 << lh) - 1));
        const int ev = eu + (1 << lh);
        const size_t j = pos(eu) & (((size_t)1 << gh) - 1);
        const Fr w = load_words(tw_inv, j << (g.log_n - 1 - gh));
        const Fr u = sm_get(sm, E, eu), v = sm_get(sm, E, ev);
        sm_put(sm, E, eu, mod_add(u, v));
        sm_put(sm, E, ev, mont_mul(mod_sub(u, v), w));
      }
      __syncthreads();
    }
  }
  if (scale != nullptr) {
    for (int e = threadIdx.x; e < E; e += blockDim.x)
      sm_put(sm, E, e, mont_mul(sm_get(sm, E, e), load_words(scale, pos(e) * (size_t)scale_stride)));
    __syncthreads();
  }
  if (DIT) {
    for (int s = 0; s < g.ns; ++s) {
      const int lh = g.tl + s, gh = bot + s;
      for (int b = threadIdx.x; b < E / 2; b += blockDim.x) {
        const int eu = ((b >> lh) << (lh + 1)) | (b & ((1 << lh) - 1));
        const int ev = eu + (1 << lh);
        const size_t j = pos(eu) & (((size_t)1 << gh) - 1);
        const Fr w = load_words(tw_fwd, j << (g.log_n - 1 - gh));
        const Fr u = sm_get(sm, E, eu);
        const Fr vw = mont_mul(sm_get(sm, E, ev), w);
        sm_put(sm, E, eu, mod_add(u, vw));
        sm_put(sm, E, ev, mod_sub(u, vw));
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    store_fp(dst, at + pos(e), (size_t)ld, sm_get(sm, E, e));
}

// blocks for n threads of `threads` a block; the block-stride loop covers the rest
inline unsigned h_grid(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  return (unsigned)blocks;
}

template <bool DIF, bool DIT>
int launch_ntt_group(const uint32_t* src, uint32_t* dst, long long ld, long long rows, NttGroup g,
                     const uint32_t* tw_inv, const uint32_t* tw_fwd, const uint32_t* scale,
                     long long scale_stride, cudaStream_t st) {
  const int E = 1 << (g.ns + g.tl);
  const size_t smem = (size_t)32 * E;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(ntt_group_kernel<DIF, DIT>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long tiles = ((long long)1 << g.log_n) >> (g.ns + g.tl);
  const dim3 grid((unsigned)(rows * tiles));
  const dim3 block(E / 2 < kNttThreads ? E / 2 : kNttThreads);
  ntt_group_kernel<DIF, DIT><<<grid, block, smem, st>>>(src, dst, ld, g, tw_inv, tw_fwd, scale,
                                                       scale_stride);
  return (int)cudaGetLastError();
}

}  // namespace zksc

extern "C" {

// K0. a: [16, N] (quotient: [16, 3, N]) with row stride in_ld; k: the
// constant's 8 words (host memory); out: [16, N]. Returns the cudaError_t
// of the launch.
int zksc_fr_elementwise(int quotient, const void* a, long long in_ld, const uint32_t* k,
                        void* out, long long N, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  zksc::Fr kc;
  for (int i = 0; i < 8; ++i) kc.w[i] = k[i];
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(zksc::h_grid(N, zksc::kHThreads)), block(zksc::kHThreads);
  const uint32_t* in = (const uint32_t*)a;
  uint32_t* o = (uint32_t*)out;
  if (quotient)
    zksc::fr_elementwise_kernel<true><<<grid, block, 0, st>>>(in, in_ld, kc, o, N);
  else
    zksc::fr_elementwise_kernel<false><<<grid, block, 0, st>>>(in, in_ld, kc, o, N);
  return (int)cudaGetLastError();
}

// K5. z: [16, k, m_pad]; row_ptr: [M n + 1] int32; cols: [nnz] int32;
// coeffs: [nnz, 8] packed words; out: [16, M, k, n].
int zksc_sparse_matvec(const void* z, long long m_pad, long long k, const void* row_ptr,
                       const void* cols, const void* coeffs, void* out, long long n,
                       long long M, void* stream) {
  const long long total = M * k * n;
  if (total <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(zksc::h_grid(total, zksc::kHThreads)), block(zksc::kHThreads);
  zksc::sparse_matvec_kernel<<<grid, block, 0, st>>>(
      (const uint32_t*)z, k * m_pad, m_pad, (const int*)row_ptr, (const int*)cols,
      (const uint32_t*)coeffs, (uint32_t*)out, n, k, total);
  return (int)cudaGetLastError();
}

// K4. src, dst: [16, rows, n] (row stride ld; dst may equal src); the group
// (top, ns, tl) of an n = 2^log_n transform; dif / dit: which stages run;
// tw_inv, tw_fwd: [n / 2, 8] packed powers of w^-1 and w; scale: null or
// [n, 8] (scale_stride 1) or [1, 8] (scale_stride 0) packed words.
int zksc_ntt_group(const void* src, void* dst, long long ld, long long rows, int log_n, int top,
                   int ns, int tl, int dif, int dit, const void* tw_inv, const void* tw_fwd,
                   const void* scale, long long scale_stride, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (log_n < 1 || ns < 1 || tl < 0 || ns + tl > zksc::kNttMaxLogTile || top >= log_n ||
      top - ns + 1 < tl)
    return (int)cudaErrorInvalidValue;
  const zksc::NttGroup g{log_n, top, ns, tl};
  const uint32_t *s = (const uint32_t*)src, *ti = (const uint32_t*)tw_inv,
                 *tf = (const uint32_t*)tw_fwd, *sc = (const uint32_t*)scale;
  uint32_t* d = (uint32_t*)dst;
  cudaStream_t st = (cudaStream_t)stream;
  if (dif && dit)
    return zksc::launch_ntt_group<true, true>(s, d, ld, rows, g, ti, tf, sc, scale_stride, st);
  if (dif)
    return zksc::launch_ntt_group<true, false>(s, d, ld, rows, g, ti, tf, sc, scale_stride, st);
  if (dit)
    return zksc::launch_ntt_group<false, true>(s, d, ld, rows, g, ti, tf, sc, scale_stride, st);
  return zksc::launch_ntt_group<false, false>(s, d, ld, rows, g, ti, tf, sc, scale_stride, st);
}

}  // extern "C"

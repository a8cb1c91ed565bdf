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
//    one pass) and the Fr.to_mont of _witnesses_to_device, one element a
//    thread: out = a k (to_mont), (a b - c) k (the quotient), the element
//    repacked as eight 32-bit words (the mat-vec's z), and the two halves
//    of a butterfly stage whose span crosses the blocks of a mesh
//    (zksc_tpu/ops/ntt_sharded.py:cross_dif / cross_dit): x + o or
//    (o - x) w (DIF), x + o w or o - x w (DIT), o the partner block's
//    element, w from a twiddle table at an offset and a stride.
// K5 sparse_matvec -- replaces zksc_tpu/groth16/prove.py:_matvec: <M, z>
//    per constraint row, the A, B and C matrices stacked as one CSR matrix
//    of M n rows. Rows are binned by length on the host (ops/h_kernels.py:
//    CSR): a short row is one thread's, a long row one warp's (the lanes
//    strided over its terms, a shuffle tree at the end), a row of more than
//    a thousand terms one block's; one launch covers the three bins. Each
//    coefficient is classed on the host as +-1, +-c with c < 2^32, or wide:
//    a term adds z, r - z, (r - z or z) times c as a 256 x 32-bit product,
//    or the Montgomery product z c from a table of the wide coefficients,
//    into a 320-bit accumulator that is reduced mod r once a row. The sums
//    are exact, so the output equals the reference's canonical sums.
// K4 ntt_group -- replaces zksc_tpu/ops/ntt.py:dif_inverse, dit_forward,
//    coset_evals_from_coeffs_br and coeffs_br_from_coset_evals: a group of
//    consecutive radix-2 stages of the same bit-reversal-free DIF / DIT
//    transforms in shared memory, then or before them the product by one
//    table (the 1/n scale, the coset shift powers, from_mont folded in by
//    the caller), over every row of a [16, rows, n] array. A transform of
//    n = 2^16-2^18 elements (32 B each) does not fit one block's 227 KB, so
//    the wrapper (ops/h_kernels.py:ntt_plan) cuts its log n stages into
//    two groups, the tile picked from the grid so that the launch has at
//    least two blocks a streaming multiprocessor: the group of the smallest
//    spans reads a contiguous chunk of E elements; a group of larger spans
//    (half-spans G .. G 2^(ns - 1)) fixes T consecutive low indices and
//    loads the 2^ns indices G apart above each, so every butterfly's
//    partner is in the tile and each limb row is read in runs of T words.
//    Each thread holds four elements and runs two stages in registers
//    between exchanges through shared memory; a tile's twiddles are staged
//    in shared memory once. DIF runs the groups from the largest spans
//    down, DIT from the smallest up; the DIF of a coset pass and the DIT
//    that follows share the group of the smallest spans, which runs both
//    in one launch. Twiddles come from one table of powers w^e (e < n / 2)
//    a direction, indexed by stride; a mesh block's local stages are the
//    C-point transform, whose table is every D-th power.
//
// Tensor layout at the boundary: 16 x 16-bit limbs per element, limb-major
// int32 arrays (fields/limb.py), element i's limb k at ptr[k * ld + i];
// inside, two limbs a 32-bit word (bn254.cuh). Tables, the wide
// coefficients and the mat-vec's z are packed by the wrapper or by K0 as
// [count, 8] words, one 32-byte element a row (two 16-byte loads).
//
// What bounds them on this card: integer multiply-adds. One Montgomery
// product is ~258 IMAD issue slots (bn254.cuh), a butterfly one product,
// an elementwise quotient two; a mat-vec term one product only where its
// coefficient is wide (else eight or sixteen multiply-adds, or none), so
// K5 is bound by its bytes: 32 B of z and 8 B of term a nonzero. What the
// design does about it: each element stays in registers or shared memory
// between its products, so an NTT group reads and writes each element
// once; the product is bn254.cuh's inlined carry-chain CIOS over Fr; a
// whole pass is a few launches instead of tens of thousands.
#include <cuda_runtime.h>

#include <cstdint>

#include "bn254.cuh"

namespace zksc {

constexpr int kHThreads = 128;      // K0, K5: one element or (row, proof) a thread
constexpr int kNttThreads = 256;    // K4: at most, four elements a thread
constexpr int kNttMaxLogTile = 11;  // 2,048 elements: 64 KB of tile, 128 KB of twiddles

// R^2 mod r: a Montgomery product by it multiplies by 2^256
__device__ __constant__ uint32_t kFrR2[8] = {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u,
                                             0x53fe3ab1u, 0x53bb8085u, 0x8c49833du,
                                             0x7f4e44a5u, 0x0216d0b1u};

// element i of a packed [count, 8]-word table
__device__ __forceinline__ Fr load_words(const uint32_t* t, size_t i) {
  const uint4* q = reinterpret_cast<const uint4*>(t + 8 * i);
  const uint4 a = q[0], b = q[1];
  Fr r;
  r.w[0] = a.x; r.w[1] = a.y; r.w[2] = a.z; r.w[3] = a.w;
  r.w[4] = b.x; r.w[5] = b.y; r.w[6] = b.z; r.w[7] = b.w;
  return r;
}

__device__ __forceinline__ void store_words(uint32_t* t, size_t i, const Fr& v) {
  uint4* q = reinterpret_cast<uint4*>(t + 8 * i);
  q[0] = uint4{v.w[0], v.w[1], v.w[2], v.w[3]};
  q[1] = uint4{v.w[4], v.w[5], v.w[6], v.w[7]};
}

// ---------------------------------------------------------------- K0

enum K0Mode { kToMont = 0, kQuotient = 1, kPack = 2, kDifHalf = 3, kDitHalf = 4 };

// a: [16, N] with row stride a_ld (the quotient: a, b, c as the three
// [16, N] parts of one [16, 3, N] array); o: the partner block [16, N]
// (row stride o_ld); element g's twiddle tw[tw_off + (g % period)
// tw_stride]; out: [16, N], or [N, 8] words (kPack).
struct K0Args {
  const uint32_t* a;
  long long a_ld;
  const uint32_t* o;
  long long o_ld;
  const uint32_t* tw;
  long long tw_off, tw_stride, period;
  int v_half;
  Fr k;
  uint32_t* out;
  long long N;
};

// kToMont: a k; kQuotient: (a b - c) k; kPack: a as words; kDifHalf: the u
// half a + o, the v half (o - a) w; kDitHalf: the u half a + o w, the v
// half o - a w (a: this block's element, o: the partner's).
template <int MODE>
__global__ void __launch_bounds__(kHThreads) fr_elementwise_kernel(K0Args p) {
  for (size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x; g < (size_t)p.N;
       g += (size_t)gridDim.x * blockDim.x) {
    Fr x = load_fp<Fr>(p.a, g, (size_t)p.a_ld);
    if constexpr (MODE == kToMont) {
      x = mont_mul(x, p.k);
    } else if constexpr (MODE == kQuotient) {
      const Fr b = load_fp<Fr>(p.a + p.N, g, (size_t)p.a_ld);
      const Fr c = load_fp<Fr>(p.a + 2 * p.N, g, (size_t)p.a_ld);
      x = mont_mul(mod_sub(mont_mul(x, b), c), p.k);
    } else if constexpr (MODE == kDifHalf || MODE == kDitHalf) {
      const Fr o = load_fp<Fr>(p.o, g, (size_t)p.o_ld);
      const bool need_w = MODE == kDitHalf || p.v_half;
      const Fr w = need_w ? load_words(p.tw, (size_t)(p.tw_off + (long long)(g % (size_t)p.period) *
                                                                     p.tw_stride))
                          : elem_zero<Fr>();
      if constexpr (MODE == kDifHalf)
        x = p.v_half ? mont_mul(mod_sub(o, x), w) : mod_add(x, o);
      else
        x = p.v_half ? mod_sub(o, mont_mul(x, w)) : mod_add(x, mont_mul(o, w));
    }
    if constexpr (MODE == kPack)
      store_words(p.out, g, x);
    else
      store_fp(p.out, g, (size_t)p.N, x);
  }
}

// ---------------------------------------------------------------- K5

// A term: x = column | kind << kTermKindShift, y = c (the +-c kinds) or the
// wide coefficient's index.
enum TermKind { kTermOne = 0, kTermMinusOne = 1, kTermSmall = 2, kTermMinusSmall = 3,
                kTermWide = 4 };
constexpr int kTermKindShift = 29;
constexpr uint32_t kTermColMask = (1u << kTermKindShift) - 1u;

// a row's running sum, 320 bits: each term adds less than r 2^32 < 2^286,
// so it holds 2^34 terms
struct Acc {
  uint32_t w[10];
};

// a += x (x < 2^256)
__device__ __forceinline__ void acc_add(Acc& a, const Fr& x) {
  asm volatile(
      "add.cc.u32  %0, %0, %10;\n\t"
      "addc.cc.u32 %1, %1, %11;\n\t"
      "addc.cc.u32 %2, %2, %12;\n\t"
      "addc.cc.u32 %3, %3, %13;\n\t"
      "addc.cc.u32 %4, %4, %14;\n\t"
      "addc.cc.u32 %5, %5, %15;\n\t"
      "addc.cc.u32 %6, %6, %16;\n\t"
      "addc.cc.u32 %7, %7, %17;\n\t"
      "addc.cc.u32 %8, %8, 0;\n\t"
      "addc.u32    %9, %9, 0;"
      : "+r"(a.w[0]), "+r"(a.w[1]), "+r"(a.w[2]), "+r"(a.w[3]), "+r"(a.w[4]), "+r"(a.w[5]),
        "+r"(a.w[6]), "+r"(a.w[7]), "+r"(a.w[8]), "+r"(a.w[9])
      : "r"(x.w[0]), "r"(x.w[1]), "r"(x.w[2]), "r"(x.w[3]), "r"(x.w[4]), "r"(x.w[5]),
        "r"(x.w[6]), "r"(x.w[7]));
}

// a += x c (x < 2^256, c < 2^32): the low words of the eight products in
// one chain, their high words one word up in another
__device__ __forceinline__ void acc_mac(Acc& a, const Fr& x, uint32_t c) {
  asm volatile(
      "mad.lo.cc.u32  %0, %10, %18, %0;\n\t"
      "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
      "addc.cc.u32    %8, %8, 0;\n\t"
      "addc.u32       %9, %9, 0;"
      : "+r"(a.w[0]), "+r"(a.w[1]), "+r"(a.w[2]), "+r"(a.w[3]), "+r"(a.w[4]), "+r"(a.w[5]),
        "+r"(a.w[6]), "+r"(a.w[7]), "+r"(a.w[8]), "+r"(a.w[9])
      : "r"(x.w[0]), "r"(x.w[1]), "r"(x.w[2]), "r"(x.w[3]), "r"(x.w[4]), "r"(x.w[5]),
        "r"(x.w[6]), "r"(x.w[7]), "r"(c));
  asm volatile(
      "mad.hi.cc.u32  %0, %9, %17, %0;\n\t"
      "madc.hi.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32       %8, %8, 0;"
      : "+r"(a.w[1]), "+r"(a.w[2]), "+r"(a.w[3]), "+r"(a.w[4]), "+r"(a.w[5]), "+r"(a.w[6]),
        "+r"(a.w[7]), "+r"(a.w[8]), "+r"(a.w[9])
      : "r"(x.w[0]), "r"(x.w[1]), "r"(x.w[2]), "r"(x.w[3]), "r"(x.w[4]), "r"(x.w[5]),
        "r"(x.w[6]), "r"(x.w[7]), "r"(c));
}

// a += b
__device__ __forceinline__ void acc_add_acc(Acc& a, const Acc& b) {
  asm volatile(
      "add.cc.u32  %0, %0, %10;\n\t"
      "addc.cc.u32 %1, %1, %11;\n\t"
      "addc.cc.u32 %2, %2, %12;\n\t"
      "addc.cc.u32 %3, %3, %13;\n\t"
      "addc.cc.u32 %4, %4, %14;\n\t"
      "addc.cc.u32 %5, %5, %15;\n\t"
      "addc.cc.u32 %6, %6, %16;\n\t"
      "addc.cc.u32 %7, %7, %17;\n\t"
      "addc.cc.u32 %8, %8, %18;\n\t"
      "addc.u32    %9, %9, %19;"
      : "+r"(a.w[0]), "+r"(a.w[1]), "+r"(a.w[2]), "+r"(a.w[3]), "+r"(a.w[4]), "+r"(a.w[5]),
        "+r"(a.w[6]), "+r"(a.w[7]), "+r"(a.w[8]), "+r"(a.w[9])
      : "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]),
        "r"(b.w[6]), "r"(b.w[7]), "r"(b.w[8]), "r"(b.w[9]));
}

// a mod r, canonical: a = lo + hi 2^256 with lo < 2^256 < 6r (five
// conditional subtractions of r) and hi < 2^64 < r (hi 2^256 = hi R, one
// Montgomery product by R^2, only where hi is not zero)
__device__ __forceinline__ Fr acc_reduce(const Acc& a) {
  uint32_t p[8];
  load_modulus<Fr>(p);
  Fr lo;
#pragma unroll
  for (int i = 0; i < 8; ++i) lo.w[i] = a.w[i];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    Fr d;
    const uint32_t bw = sub8(d.w, lo.w, p);
#pragma unroll
    for (int i = 0; i < 8; ++i) lo.w[i] = bw ? lo.w[i] : d.w[i];
  }
  if ((a.w[8] | a.w[9]) == 0u) return lo;
  Fr hi = elem_zero<Fr>(), r2;
  hi.w[0] = a.w[8];
  hi.w[1] = a.w[9];
#pragma unroll
  for (int i = 0; i < 8; ++i) r2.w[i] = kFrR2[i];
  return mod_add(lo, mont_mul(hi, r2));
}

// z: [k, m_pad, 8] packed Montgomery words; row_ptr: [M n + 1]; terms:
// [nnz]; wide: [n_wide, 8] Montgomery coefficients; bin_rows: the stacked
// rows (m n + row) of the short bin (n0 of them), then the warp bin (n1),
// then the block bin (n2); the first b0 blocks take the short bin, the next
// b1 the warp bin, one block each (row, proof) of the block bin after
// them. out: [16, M, k, n], (row R, proof j) at (m k + j) n + row.
struct CsrArgs {
  const uint32_t* z;
  long long m_pad;
  const int* row_ptr;
  const uint2* terms;
  const uint32_t* wide;
  const int* bin_rows;
  long long n0, n1, n2, b0, b1;
  uint32_t* out;
  long long n, k, total;
};

__device__ __forceinline__ void add_term(Acc& acc, const uint32_t* zj, uint2 tm,
                                         const uint32_t* wide) {
  const uint32_t kind = tm.x >> kTermKindShift;
  Fr z = load_words(zj, tm.x & kTermColMask);
  if (kind & 1u) z = mod_sub(elem_zero<Fr>(), z);   // r - z (0 for z = 0)
  if (kind == kTermWide)
    acc_add(acc, mont_mul(z, load_words(wide, tm.y)));
  else if (kind >= kTermSmall)
    acc_mac(acc, z, tm.y);
  else
    acc_add(acc, z);
}

__device__ __forceinline__ void acc_zero(Acc& a) {
#pragma unroll
  for (int i = 0; i < 10; ++i) a.w[i] = 0u;
}

// the sum over the 32 lanes of a warp, on every lane
__device__ __forceinline__ void warp_sum(Acc& acc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Acc o;
#pragma unroll
    for (int i = 0; i < 10; ++i) o.w[i] = __shfl_sync(0xffffffffu, acc.w[i], lane ^ off);
    acc_add_acc(acc, o);
  }
}

__device__ __forceinline__ void store_row(const CsrArgs& a, long long R, long long j,
                                          const Acc& acc) {
  const long long m = R / a.n, row = R % a.n;
  store_fp(a.out, (size_t)((m * a.k + j) * a.n + row), (size_t)a.total, acc_reduce(acc));
}

__global__ void __launch_bounds__(kHThreads) sparse_matvec_kernel(CsrArgs a) {
  const long long blk = blockIdx.x;
  Acc acc;
  acc_zero(acc);
  if (blk < a.b0) {                                   // a thread a (row, proof)
    const long long g = blk * blockDim.x + threadIdx.x;
    if (g >= a.n0 * a.k) return;
    const long long j = g / a.n0, R = a.bin_rows[g % a.n0];
    const uint32_t* zj = a.z + (size_t)j * a.m_pad * 8;
    for (int t = a.row_ptr[R]; t < a.row_ptr[R + 1]; ++t) add_term(acc, zj, a.terms[t], a.wide);
    store_row(a, R, j, acc);
  } else if (blk < a.b0 + a.b1) {                     // a warp a (row, proof)
    const long long g = (blk - a.b0) * (blockDim.x / 32) + threadIdx.x / 32;
    if (g >= a.n1 * a.k) return;                      // the whole warp
    const long long j = g / a.n1, R = a.bin_rows[a.n0 + g % a.n1];
    const uint32_t* zj = a.z + (size_t)j * a.m_pad * 8;
    for (int t = a.row_ptr[R] + (threadIdx.x & 31); t < a.row_ptr[R + 1]; t += 32)
      add_term(acc, zj, a.terms[t], a.wide);
    warp_sum(acc);
    if ((threadIdx.x & 31) == 0) store_row(a, R, j, acc);
  } else {                                            // a block a (row, proof)
    __shared__ uint32_t part[kHThreads / 32][10];
    const long long g = blk - a.b0 - a.b1;
    const long long j = g / a.n2, R = a.bin_rows[a.n0 + a.n1 + g % a.n2];
    const uint32_t* zj = a.z + (size_t)j * a.m_pad * 8;
    for (int t = a.row_ptr[R] + threadIdx.x; t < a.row_ptr[R + 1]; t += blockDim.x)
      add_term(acc, zj, a.terms[t], a.wide);
    warp_sum(acc);
    if ((threadIdx.x & 31) == 0)
      for (int i = 0; i < 10; ++i) part[threadIdx.x / 32][i] = acc.w[i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < (int)blockDim.x / 32; ++w) {
        Acc o;
        for (int i = 0; i < 10; ++i) o.w[i] = part[w][i];
        acc_add_acc(acc, o);
      }
      store_row(a, R, j, acc);
    }
  }
}

// ---------------------------------------------------------------- K4

// One K4 stage group of an n = 2^log_n transform: global half-spans
// 2^(top - ns + 1) .. 2^top, tiles of E = 2^(ns + tl) elements, T = 2^tl
// consecutive low indices each.
struct NttGroup {
  int log_n, top, ns, tl;
};

// word w of entry e of a word-planar array of `count` entries
__device__ __forceinline__ Fr sm_get(const uint32_t* sm, int count, int e) {
  Fr r;
#pragma unroll
  for (int w = 0; w < 8; ++w) r.w[w] = sm[w * count + e];
  return r;
}

__device__ __forceinline__ void sm_put(uint32_t* sm, int count, int e, const Fr& v) {
#pragma unroll
  for (int w = 0; w < 8; ++w) sm[w * count + e] = v.w[w];
}

// A tile in shared memory: its E elements word-planar, then S = T (2^ns - 1)
// twiddles a direction, word-planar: the local stage l (local half-span
// 2^(tl + l)) keeps its twiddles at (2^l - 1) T + (e mod 2^(l + tl)) for
// the butterfly whose u element is local element e.
struct Tile {
  uint32_t* x;
  int E, S, T, tl;
  __device__ __forceinline__ Fr get(int e) const { return sm_get(x, E, e); }
  __device__ __forceinline__ void put(int e, const Fr& v) const { sm_put(x, E, e, v); }
  __device__ __forceinline__ Fr twiddle(const uint32_t* t, int l, int e) const {
    return sm_get(t, S, ((1 << l) - 1) * T + (e & ((1 << (l + tl)) - 1)));
  }
};

__device__ __forceinline__ void dif_bfly(Fr& u, Fr& v, const Fr& w) {
  const Fr s = mod_add(u, v);
  v = mont_mul(mod_sub(u, v), w);
  u = s;
}

__device__ __forceinline__ void dit_bfly(Fr& u, Fr& v, const Fr& w) {
  const Fr vw = mont_mul(v, w);
  v = mod_sub(u, vw);
  u = mod_add(u, vw);
}

// DIF stages l and l - 1 (l >= 1) in registers, four elements a thread:
// e0, e0 + h, e0 + 2h, e0 + 3h with h = 2^(tl + l - 1)
__device__ __forceinline__ void dif_pair(const Tile& s, const uint32_t* tw, int l) {
  const int lh = s.tl + l, h = 1 << (lh - 1);
  for (int q = threadIdx.x; q < s.E / 4; q += blockDim.x) {
    const int e0 = ((q >> (lh - 1)) << (lh + 1)) | (q & (h - 1));
    Fr x0 = s.get(e0), x1 = s.get(e0 + h), x2 = s.get(e0 + 2 * h), x3 = s.get(e0 + 3 * h);
    dif_bfly(x0, x2, s.twiddle(tw, l, e0));
    dif_bfly(x1, x3, s.twiddle(tw, l, e0 + h));
    const Fr w = s.twiddle(tw, l - 1, e0);
    dif_bfly(x0, x1, w);
    dif_bfly(x2, x3, w);
    s.put(e0, x0); s.put(e0 + h, x1); s.put(e0 + 2 * h, x2); s.put(e0 + 3 * h, x3);
  }
  __syncthreads();
}

// DIT stages l and l + 1 in registers: e0, e0 + h, e0 + 2h, e0 + 3h with
// h = 2^(tl + l)
__device__ __forceinline__ void dit_pair(const Tile& s, const uint32_t* tw, int l) {
  const int lh = s.tl + l, h = 1 << lh;
  for (int q = threadIdx.x; q < s.E / 4; q += blockDim.x) {
    const int e0 = ((q >> lh) << (lh + 2)) | (q & (h - 1));
    Fr x0 = s.get(e0), x1 = s.get(e0 + h), x2 = s.get(e0 + 2 * h), x3 = s.get(e0 + 3 * h);
    const Fr w = s.twiddle(tw, l, e0);
    dit_bfly(x0, x1, w);
    dit_bfly(x2, x3, w);
    dit_bfly(x0, x2, s.twiddle(tw, l + 1, e0));
    dit_bfly(x1, x3, s.twiddle(tw, l + 1, e0 + h));
    s.put(e0, x0); s.put(e0 + h, x1); s.put(e0 + 2 * h, x2); s.put(e0 + 3 * h, x3);
  }
  __syncthreads();
}

// one DIF or DIT stage l, two elements a butterfly
template <bool DIF>
__device__ __forceinline__ void single_stage(const Tile& s, const uint32_t* tw, int l) {
  const int lh = s.tl + l, h = 1 << lh;
  for (int b = threadIdx.x; b < s.E / 2; b += blockDim.x) {
    const int eu = ((b >> lh) << (lh + 1)) | (b & (h - 1));
    Fr u = s.get(eu), v = s.get(eu + h);
    if (DIF)
      dif_bfly(u, v, s.twiddle(tw, l, eu));
    else
      dit_bfly(u, v, s.twiddle(tw, l, eu));
    s.put(eu, u);
    s.put(eu + h, v);
  }
  __syncthreads();
}

// K4 -- block = one tile of one row of src / dst ([16, rows, n], row stride
// ld; dst may be src). DIF: the group's stages from the largest span down,
// (u, v) -> (u + v, (u - v) w^-j); then, where scale is given, the product
// by scale[i * scale_stride] (i: the position in the row); then DIT: the
// stages from the smallest span up, (u, v) -> (u + v w^j, u - v w^j).
template <bool DIF, bool DIT>
__global__ void __launch_bounds__(kNttThreads) ntt_group_kernel(
    const uint32_t* src, uint32_t* dst, long long ld, NttGroup g, const uint32_t* tw_inv,
    const uint32_t* tw_fwd, const uint32_t* scale, long long scale_stride) {
  extern __shared__ uint32_t sm[];
  Tile s;
  s.x = sm;
  s.tl = g.tl;
  s.T = 1 << g.tl;
  s.E = 1 << (g.ns + g.tl);
  s.S = s.T * ((1 << g.ns) - 1);
  uint32_t* tws_inv = sm + 8 * s.E;
  uint32_t* tws_fwd = tws_inv + (DIF ? 8 * s.S : 0);
  const int bot = g.top - g.ns + 1;
  const size_t n = (size_t)1 << g.log_n;
  const size_t tiles = n >> (g.ns + g.tl);
  const size_t row = blockIdx.x / tiles, q = blockIdx.x % tiles;
  const size_t per_outer = ((size_t)1 << bot) >> g.tl;    // tiles of one outer block
  const size_t low0 = (q % per_outer) << g.tl;           // the tile's first low index
  const size_t first = (q / per_outer) * ((size_t)2 << g.top) + low0;
  const size_t T1 = (size_t)s.T - 1;
  // position in the row of local element e
  auto pos = [&](int e) { return first + ((size_t)(e >> g.tl) << bot) + ((size_t)e & T1); };
  const size_t at = row * n;

  for (int e = threadIdx.x; e < s.E; e += blockDim.x)
    s.put(e, load_fp<Fr>(src, at + pos(e), (size_t)ld));
  // the twiddles: entry (2^l - 1) T + a T + c of stage l is w^(j 2^(log_n - 1
  // - bot - l)) with j = low0 + c + (a << bot), its global index mod 2^(bot + l)
  for (int i = threadIdx.x; i < s.S; i += blockDim.x) {
    int l = 0;
    while (((2 << l) - 1) * s.T <= i) ++l;
    const int rem = i - ((1 << l) - 1) * s.T;
    const size_t j = low0 + ((size_t)rem & T1) + ((size_t)(rem >> g.tl) << bot);
    const size_t idx = j << (g.log_n - 1 - bot - l);
    if (DIF) sm_put(tws_inv, s.S, i, load_words(tw_inv, idx));
    if (DIT) sm_put(tws_fwd, s.S, i, load_words(tw_fwd, idx));
  }
  __syncthreads();
  if constexpr (DIF) {
    int l = g.ns - 1;
    for (; l >= 1; l -= 2) dif_pair(s, tws_inv, l);
    if (l == 0) single_stage<true>(s, tws_inv, 0);
  }
  if (scale != nullptr) {
    for (int e = threadIdx.x; e < s.E; e += blockDim.x)
      s.put(e, mont_mul(s.get(e), load_words(scale, pos(e) * (size_t)scale_stride)));
    __syncthreads();
  }
  if constexpr (DIT) {
    int l = 0;
    for (; l + 1 < g.ns; l += 2) dit_pair(s, tws_fwd, l);
    if (l < g.ns) single_stage<false>(s, tws_fwd, l);
  }
  for (int e = threadIdx.x; e < s.E; e += blockDim.x)
    store_fp(dst, at + pos(e), (size_t)ld, s.get(e));
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
  const int S = (1 << g.tl) * ((1 << g.ns) - 1);
  const size_t smem = (size_t)32 * E + (size_t)32 * S * ((DIF ? 1 : 0) + (DIT ? 1 : 0));
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(ntt_group_kernel<DIF, DIT>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long tiles = ((long long)1 << g.log_n) >> (g.ns + g.tl);
  const dim3 grid((unsigned)(rows * tiles));
  const int threads = E / 4 < 1 ? 1 : (E / 4 < kNttThreads ? E / 4 : kNttThreads);
  const dim3 block(threads);
  ntt_group_kernel<DIF, DIT><<<grid, block, smem, st>>>(src, dst, ld, g, tw_inv, tw_fwd, scale,
                                                       scale_stride);
  return (int)cudaGetLastError();
}

}  // namespace zksc

extern "C" {

// K0. mode: 0 to_mont, 1 quotient, 2 pack, 3 DIF half, 4 DIT half. a:
// [16, N] (quotient: [16, 3, N]) with row stride a_ld; o: the partner block
// [16, N], row stride o_ld (modes 3, 4; else null); tw, tw_off, tw_stride,
// period: element g's twiddle tw[tw_off + (g % period) tw_stride] (modes 3,
// 4); v_half: this block holds the v half; k: the constant's 8 words (host
// memory; modes 0, 1); out: [16, N], or [N, 8] words (pack). Returns the
// cudaError_t of the launch.
int zksc_fr_elementwise(int mode, const void* a, long long a_ld, const void* o, long long o_ld,
                        const void* tw, long long tw_off, long long tw_stride, long long period,
                        int v_half, const uint32_t* k, void* out, long long N, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if ((mode == zksc::kDifHalf || mode == zksc::kDitHalf) && period <= 0)
    return (int)cudaErrorInvalidValue;
  zksc::K0Args p{(const uint32_t*)a, a_ld, (const uint32_t*)o, o_ld, (const uint32_t*)tw,
                 tw_off, tw_stride, period, v_half, zksc::Fr{}, (uint32_t*)out, N};
  if (k != nullptr)
    for (int i = 0; i < 8; ++i) p.k.w[i] = k[i];
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(zksc::h_grid(N, zksc::kHThreads)), block(zksc::kHThreads);
  if (mode == zksc::kToMont)
    zksc::fr_elementwise_kernel<zksc::kToMont><<<grid, block, 0, st>>>(p);
  else if (mode == zksc::kQuotient)
    zksc::fr_elementwise_kernel<zksc::kQuotient><<<grid, block, 0, st>>>(p);
  else if (mode == zksc::kPack)
    zksc::fr_elementwise_kernel<zksc::kPack><<<grid, block, 0, st>>>(p);
  else if (mode == zksc::kDifHalf)
    zksc::fr_elementwise_kernel<zksc::kDifHalf><<<grid, block, 0, st>>>(p);
  else if (mode == zksc::kDitHalf)
    zksc::fr_elementwise_kernel<zksc::kDitHalf><<<grid, block, 0, st>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K5. z: [k, m_pad, 8] packed words; row_ptr: [M n + 1] int32; terms: [nnz]
// pairs of words; wide: [n_wide, 8] packed words; bin_rows: [M n] int32,
// the short bin's n0 rows, the warp bin's n1, the block bin's n2; out:
// [16, M, k, n].
int zksc_sparse_matvec(const void* z, long long m_pad, long long k, const void* row_ptr,
                       const void* terms, const void* wide, const void* bin_rows, long long n0,
                       long long n1, long long n2, void* out, long long n, long long M,
                       void* stream) {
  const long long total = M * k * n;
  if (total <= 0) return (int)cudaSuccess;
  if (n0 + n1 + n2 != M * n) return (int)cudaErrorInvalidValue;
  const long long warps = zksc::kHThreads / 32;
  const long long b0 = (n0 * k + zksc::kHThreads - 1) / zksc::kHThreads;
  const long long b1 = (n1 * k + warps - 1) / warps;
  const long long blocks = b0 + b1 + n2 * k;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  zksc::CsrArgs a{(const uint32_t*)z, m_pad, (const int*)row_ptr, (const uint2*)terms,
                  (const uint32_t*)wide, (const int*)bin_rows, n0, n1, n2, b0, b1,
                  (uint32_t*)out, n, k, total};
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks), block(zksc::kHThreads);
  zksc::sparse_matvec_kernel<<<grid, block, 0, st>>>(a);
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

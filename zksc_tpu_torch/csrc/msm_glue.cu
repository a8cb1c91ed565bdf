// Hand-written Hopper (sm_90a) kernels for the glue of the bucket MSM
// (K6): the work of zksc_tpu/ops/msm.py:_window_sums around its Pallas
// kernels (the local scans, K1, and the tiled adds, K2), which the
// reference leaves to XLA to fuse (no pl.pallas_call) and which eager
// PyTorch ran as ~100 launches a MSM plus a host synchronisation.
//
// K6a msm_keys_kernel -- zksc_tpu/ops/msm.py:67 scalars_to_digits and
//    :214-221 (the flipped keys, segment_sum): reads the plain 16-bit
//    scalar limbs [L, k, n] and writes every (proof, window) segment's
//    keys seg * 2^c + (2^c - 1 - digit) and the histogram of the keys,
//    through a shared-memory histogram where 2^c bins fit (c <= 13),
//    else global atomics. A thread's equal digits in a row are counted
//    once (witness digits repeat: 0/1 wires), so the atomics do not
//    serialise on one bin.
// K6b pack_points_kernel, sorted_gather_kernel -- :225 (the gather of the
//    sorted points): the point table packed point-major once a call, then
//    the point of sorted position p = chunk * S + step, index sidx[p] % n,
//    written to K1's step-major lane step * C0 + chunk (C0 = 0: lane p).
// K6c scan_top_kernel -- :164 _hs_scan: a prefix sum under COMPLETE
//    addition of the scan's top level (at most _HS_MAX lanes), or of a
//    whole small MSM. Lanes are cut into runs of m, a block takes P runs
//    (a tile) and a thread (G2: a thread pair) a run: the run's total, a
//    Hillis-Steele scan of the block's run totals in shared memory, then
//    the run walked from its offset. With B > 1 tiles, a first launch
//    writes every run's inclusive sum in its tile, and the scanning launch
//    reads those, scans the tile totals and walks the runs: no run sum or
//    in-tile scan is computed twice.
//    The adds come in another order than the reference's Hillis-Steele:
//    the same points, other Jacobian representatives; the plain version
//    (ops/msm_glue.py:scan_top_plain) follows this order.
// K6d segment_prefix_kernel, bucket_kernel -- :241-273: the bucket
//    boundaries. One thread per (proof, window) segment adds its segment
//    prefix (the inclusive prefix at s * n - 1, negated; identity for
//    segment 0); then one thread per q-major bucket lane q * segs + s
//    finds its position from the cumulative counts, reads level 0 there,
//    adds each upper level's offset (incomplete, as the reference does),
//    adds the segment prefix (incomplete) and writes the identity where
//    the bucket is empty or is the digit-0 bucket.
//
// What bounds them on this card: K6a and K6b move bytes (K6b writes every
// sorted point, 192 B a G1 lane in limb-major int32); K6d is integer
// multiply-adds (2-4 incomplete adds a live bucket lane); K6c is the
// chain of complete adds a thread waits on (2m + log2 P + log2 B adds),
// on at most 64 blocks. What the designs do about it: K6a reads two limb
// rows a window and writes each key once, its histogram in shared memory;
// K6b gives a thread an output lane, so the writes coalesce, and reads
// its point as one packed row: limb-major, a lane's 48 (G2 96) limbs were
// as many 32-byte sectors, which held the gather to 8-19% of its byte
// bound on an H100 (the table exceeds L2 at 2^18, PERF.md); K6d skips every masked lane
// before any load and keeps the point formula in registers (bn254.cuh);
// K6c keeps a run's sum in registers and the block's in shared memory.
//
// Layouts at the boundary as in ec_kernels.cu: 16 x 16-bit limbs per Fp,
// limb-major int32; a G2 coordinate two component arrays with one row
// stride (folded [c0 | c1] or a [16, 2, n] view).
#include <cuda_runtime.h>

#include <cstdint>

#include "bn254.cuh"

namespace zksc {

constexpr int kScanSteps = 16;          // K1's chunk width (ops/msm.py _SCAN_S)
constexpr int kGlueThreads = 128;       // K6b, K6c, K6d
constexpr int kKeyThreads = 256;        // K6a
constexpr int kKeysPerThread = 16;
constexpr int kSharedHistMaxBits = 13;  // 2^13 bins: 32 KB of shared memory
constexpr int kMaxLevels = 8;           // scan levels K6d reads (level 0 too)

// One compiled copy of each point add the glue kernels call. ptxas
// compiles an inlined point formula once per call site, and inlined at the
// glue's ~40 sites it took ~200 s of nvcc on the H100 machine; K1 and K2,
// one site an instance, keep theirs inlined.
template <class F, bool COMPLETE>
__device__ __noinline__ Jac<F> glue_add(Jac<F> P, Jac<F> Q) {
  return jac_add<F, COMPLETE>(P, Q);
}

// ---------------------------------------------------------------- K6a

// Segment seg = j * W + w of blockIdx.y: lanes [base, base + 4,096) of
// proof j, window w. Scalar limb l of proof j, lane i at s[l * ls + j * js
// + i]. keys[seg * n + i] = seg * 2^c + (2^c - 1 - digit); counts[seg *
// 2^c + f] += 1 (the caller zeroes counts).
template <class Key, bool SHARED>
__global__ void __launch_bounds__(kKeyThreads) msm_keys_kernel(
    const uint32_t* s, long long ls, long long js, int L, int c, int W, long long n,
    Key* keys, uint32_t* counts) {
  extern __shared__ uint32_t hist[];
  const int seg = blockIdx.y;
  const int j = seg / W, w = seg % W;
  const uint32_t two_c = 1u << c, mask = two_c - 1u;
  const int lo_bit = w * c, lo = lo_bit / 16, off = lo_bit % 16;
  const bool two = off + c > 16 && lo + 1 < L;
  const uint32_t* row0 = s + (size_t)lo * ls + (size_t)j * js;
  const uint32_t* row1 = row0 + (two ? ls : 0);
  uint32_t* bins = SHARED ? hist : counts + (size_t)seg * two_c;
  if (SHARED) {
    for (uint32_t b = threadIdx.x; b < two_c; b += kKeyThreads) hist[b] = 0u;
    __syncthreads();
  }
  const long long base = (long long)blockIdx.x * kKeyThreads * kKeysPerThread;
  uint32_t run_f = 0u, run_n = 0u;
  for (int t = 0; t < kKeysPerThread; ++t) {
    const long long i = base + (long long)t * kKeyThreads + threadIdx.x;
    if (i >= n) break;
    uint32_t d = row0[i] >> off;
    if (two) d |= row1[i] << (16 - off);
    const uint32_t f = mask - (d & mask);
    keys[(size_t)seg * n + i] = (Key)seg * (Key)two_c + (Key)f;
    if (run_n != 0u && f != run_f) {
      atomicAdd(&bins[run_f], run_n);
      run_n = 0u;
    }
    run_f = f;
    ++run_n;
  }
  if (run_n != 0u) atomicAdd(&bins[run_f], run_n);
  if (SHARED) {
    __syncthreads();
    for (uint32_t b = threadIdx.x; b < two_c; b += kKeyThreads)
      if (hist[b] != 0u) atomicAdd(&counts[(size_t)seg * two_c + b], hist[b]);
  }
}

// ---------------------------------------------------------------- K6b

// A scan level's lane of sorted position pos = chunk * S + step: lane
// step * chunks + chunk over `chunks` step-major chunks (K1's layout), or
// pos itself (chunks == 0: position order); position_of is its inverse.
__device__ __forceinline__ long long lane_of(long long pos, long long chunks) {
  return chunks ? (pos % kScanSteps) * chunks + pos / kScanSteps : pos;
}

__device__ __forceinline__ long long position_of(long long lane, long long chunks) {
  return chunks ? (lane % chunks) * kScanSteps + lane / chunks : lane;
}

// The point table point-major: point i's ncomp components (G1 x, y, z;
// G2 x0, x1, y0, y1, z0, z1) as 8 words each (limb 2k | limb 2k+1 << 16),
// one row of ncomp * 8 words a point, so that a lane of the gather reads
// one 96-byte (G2 192-byte) row and not 16 * ncomp scattered limbs.
__global__ void __launch_bounds__(kGlueThreads) pack_points_kernel(InArrs src, int ncomp,
                                                                   uint32_t* packed, long long n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < (size_t)n;
       i += (size_t)gridDim.x * blockDim.x) {
    uint32_t* row = packed + i * (size_t)(8 * ncomp);
    for (int c = 0; c < ncomp; ++c) {
      const uint32_t* a = src.p[c];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        row[8 * c + k] = a[(size_t)(2 * k) * src.ld + i] | (a[(size_t)(2 * k + 1) * src.ld + i] << 16);
    }
  }
}

// Out lane `lane` = packed point sidx[position_of(lane)] % n, unpacked to
// the ncomp limb-major component arrays of dst.
__global__ void __launch_bounds__(kGlueThreads) sorted_gather_kernel(
    const uint32_t* packed, int ncomp, OutArrs dst, const long long* sidx, long long n,
    long long N, long long C0) {
  for (size_t lane = (size_t)blockIdx.x * blockDim.x + threadIdx.x; lane < (size_t)N;
       lane += (size_t)gridDim.x * blockDim.x) {
    const size_t i = (size_t)(sidx[position_of((long long)lane, C0)] % n);
    const uint4* row = reinterpret_cast<const uint4*>(packed + i * (size_t)(8 * ncomp));
    for (int c = 0; c < ncomp; ++c) {
      uint32_t* b = dst.p[c];
      const uint4 lo = row[2 * c], hi = row[2 * c + 1];
      const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        b[(size_t)(2 * k) * dst.ld + lane] = w[k] & 0xFFFFu;
        b[(size_t)(2 * k + 1) * dst.ld + lane] = w[k] >> 16;
      }
    }
  }
}

// ---------------------------------------------------------------- K6c

__device__ __forceinline__ Fp& elem(Fp& f) { return f; }
__device__ __forceinline__ Fp& elem(Fp2h& f) { return f.v; }

// a thread's share of a point (G1: the point; G2: its component) in
// shared memory, one column per thread
struct ScanShared {
  uint32_t w[3][8][kGlueThreads];
};

template <class F>
__device__ __forceinline__ void put(ScanShared& sh, int t, Jac<F> P) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    sh.w[0][k][t] = elem(P.x).w[k];
    sh.w[1][k][t] = elem(P.y).w[k];
    sh.w[2][k][t] = elem(P.z).w[k];
  }
}

template <class F>
__device__ __forceinline__ Jac<F> get(const ScanShared& sh, int t) {
  Jac<F> P;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    elem(P.x).w[k] = sh.w[0][k][t];
    elem(P.y).w[k] = sh.w[1][k][t];
    elem(P.z).w[k] = sh.w[2][k][t];
  }
  return P;
}

// Inclusive Hillis-Steele scan over the block's slots, in place: slot s
// becomes sh[s - d] + sh[s] for d = 1, 2, 4, ... < rounds_below. Every
// thread of the block calls it (it synchronises).
template <class F>
__device__ __forceinline__ Jac<F> block_scan(ScanShared& sh, Jac<F> v, int rounds_below) {
  constexpr int T = kThreadsPerLane<F>;
  const int t = threadIdx.x, slot = t / T;
  put<F>(sh, t, v);
  __syncthreads();
  for (int d = 1; d < rounds_below; d *= 2) {
    if (slot >= d) v = glue_add<F, true>(get<F>(sh, t - d * T), v);
    __syncthreads();
    put<F>(sh, t, v);
    __syncthreads();
  }
  return v;
}

// Lanes [0, T) of `in`: run r = lanes [r m, r m + m), tile b = runs
// [b P, b P + P), P = kGlueThreads / (threads a lane), B tiles (B <= P).
// totals: writes run r's inclusive sum in its tile to runs[r]. Else: the
// scan (inclusive, or the sum before each lane); with B > 1 it reads
// runs[0, B P) and scans the tile totals runs[b P + P - 1] first.
template <class F>
__global__ void __launch_bounds__(kGlueThreads) scan_top_kernel(
    InArrs in, OutArrs out, InArrs runs_in, OutArrs runs_out, long long T, int m, int B,
    int inclusive, int totals) {
  constexpr int TPL = kThreadsPerLane<F>;
  constexpr int P = kGlueThreads / TPL;
  __shared__ ScanShared sh;
  const int t = threadIdx.x, slot = t / TPL;
  const long long run = (long long)blockIdx.x * P + slot, lo = run * m;
  Jac<F> excl = jac_identity<F>();
  Jac<F> off = jac_identity<F>();
  if (B == 1 || totals) {
    Jac<F> acc = jac_identity<F>();
    for (int j = 0; j < m; ++j)
      if (lo + j < T) acc = glue_add<F, true>(acc, load_point<F>(in, (size_t)(lo + j)));
    const Jac<F> incl = block_scan<F>(sh, acc, P);
    if (totals) {
      store_point<F>(runs_out, (size_t)run, incl);
      return;
    }
    // sh holds the inclusive run sums: the run's offset in its tile
    if (slot > 0) excl = get<F>(sh, t - TPL);
  } else {
    if (slot > 0) excl = load_point<F>(runs_in, (size_t)(run - 1));
    const Jac<F> u = slot < B ? load_point<F>(runs_in, (size_t)slot * P + P - 1)
                              : jac_identity<F>();
    block_scan<F>(sh, u, B);
    if (blockIdx.x > 0) off = get<F>(sh, (int)(blockIdx.x - 1) * TPL + (t % TPL));
  }
  // the tile's offset plus the run's, then the run's lanes
  for (int j = -1; j < m; ++j) {
    if (lo + j >= T) break;
    const Jac<F> y = glue_add<F, true>(off, j < 0 ? excl : load_point<F>(in, (size_t)(lo + j)));
    if (j >= 0) store_point<F>(out, (size_t)(lo + j), inclusive ? y : off);
    off = y;
  }
}

// ---------------------------------------------------------------- K6d

// The scan's levels as K6d reads them: level 0 the inclusive scan s0
// (stride 1), then each upper level's exclusive offsets; level l holds
// lanes[l] lanes, step-major over chunks[l] chunks (0: position order).
struct Levels {
  InArrs arr[kMaxLevels];
  long long stride[kMaxLevels];
  long long chunks[kMaxLevels];
  long long lanes[kMaxLevels];
  int count;
};

// the inclusive prefix sum at sorted position pos: level 0 there plus
// each upper level's offset, incomplete adds
template <class F>
__device__ __forceinline__ Jac<F> prefix_at(const Levels& lv, long long pos) {
  Jac<F> acc = load_point<F>(lv.arr[0], (size_t)lane_of(pos, lv.chunks[0]));
  for (int l = 1; l < lv.count; ++l) {
    long long e = pos / lv.stride[l];
    if (e > lv.lanes[l] - 1) e = lv.lanes[l] - 1;
    acc = glue_add<F, false>(acc, load_point<F>(lv.arr[l], (size_t)lane_of(e, lv.chunks[l])));
  }
  return acc;
}

template <class F>
__global__ void __launch_bounds__(kGlueThreads) segment_prefix_kernel(
    Levels lv, OutArrs pre, long long segs, long long n, long long N) {
  constexpr int T = kThreadsPerLane<F>;
  for (size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x; g < (size_t)segs * T;
       g += (size_t)gridDim.x * blockDim.x) {
    const long long s = (long long)(g / T);
    long long pos = s * n - 1;
    if (pos < 0) pos = 0;
    if (pos > N - 1) pos = N - 1;
    Jac<F> P = prefix_at<F>(lv, pos);
    F zero;
    f_set_zero(zero);
    P.y = f_sub(zero, P.y);
    if (s == 0) f_set_zero(P.z);
    store_point<F>(pre, (size_t)s, P);
  }
}

// lane = q * segs + s; cum[s * 2^c + q]: points of segment s whose
// flipped digit is <= q
template <class F>
__global__ void __launch_bounds__(kGlueThreads) bucket_kernel(
    Levels lv, InArrs pre, const int* cum, OutArrs out, int c, long long segs, long long n,
    long long N) {
  constexpr int T = kThreadsPerLane<F>;
  const long long two_c = 1ll << c;
  for (size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < (size_t)(two_c * segs) * T; g += (size_t)gridDim.x * blockDim.x) {
    const long long lane = (long long)(g / T);
    const long long q = lane / segs, s = lane % segs;
    const long long cnt = cum[s * two_c + q];
    if (cnt == 0 || q == two_c - 1) {
      store_point<F>(out, (size_t)lane, jac_identity<F>());
      continue;
    }
    long long pos = s * n + cnt - 1;
    if (pos > N - 1) pos = N - 1;
    const Jac<F> V = prefix_at<F>(lv, pos);
    store_point<F>(out, (size_t)lane, glue_add<F, false>(V, load_point<F>(pre, (size_t)s)));
  }
}

// blocks for `threads` threads; the block-stride loops cover the rest
inline unsigned glue_grid(long long threads) {
  long long blocks = (threads + kGlueThreads - 1) / kGlueThreads;
  if (blocks > 65535) blocks = 65535;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

inline InArrs glue_in(const void* const* p, long long ld) {
  InArrs a;
  for (int i = 0; i < 6; ++i) a.p[i] = (const uint32_t*)p[i];
  a.ld = ld;
  return a;
}

inline OutArrs glue_out(void* const* p, long long ld) {
  OutArrs a;
  for (int i = 0; i < 6; ++i) a.p[i] = (uint32_t*)p[i];
  a.ld = ld;
  return a;
}

}  // namespace zksc

using zksc::Fp;
using zksc::Fp2h;

extern "C" {

// K6a. scalars: plain 16-bit limbs as int32, limb l of proof j and lane i
// at scalars[l * ls + j * js + i] (L limbs, k proofs, n lanes); keys:
// [k * W * n] int32 (key64: int64); counts: [k * W * 2^c] int32, zeroed
// here. Returns the cudaError_t of the launch.
int zksc_msm_keys(int key64, const void* scalars, long long ls, long long js, int L,
                  int c, int W, int k, long long n, void* keys, void* counts,
                  void* stream) {
  if (c < 1 || c > 16 || W < 1 || k < 1 || k * W > 65535 || (W - 1) * c / 16 >= L)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t bins = (size_t)k * W << c;
  cudaError_t e = cudaMemsetAsync(counts, 0, bins * sizeof(uint32_t), st);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return (int)cudaSuccess;
  const long long per_block = (long long)zksc::kKeyThreads * zksc::kKeysPerThread;
  const dim3 grid((unsigned)((n + per_block - 1) / per_block), (unsigned)(k * W));
  const dim3 block(zksc::kKeyThreads);
  const uint32_t* s = (const uint32_t*)scalars;
  uint32_t* cnt = (uint32_t*)counts;
  const bool shared = c <= zksc::kSharedHistMaxBits;
  const size_t smem = shared ? (sizeof(uint32_t) << c) : 0;
  if (key64) {
    long long* kp = (long long*)keys;
    if (shared)
      zksc::msm_keys_kernel<long long, true><<<grid, block, smem, st>>>(s, ls, js, L, c, W, n, kp, cnt);
    else
      zksc::msm_keys_kernel<long long, false><<<grid, block, smem, st>>>(s, ls, js, L, c, W, n, kp, cnt);
  } else {
    int* kp = (int*)keys;
    if (shared)
      zksc::msm_keys_kernel<int, true><<<grid, block, smem, st>>>(s, ls, js, L, c, W, n, kp, cnt);
    else
      zksc::msm_keys_kernel<int, false><<<grid, block, smem, st>>>(s, ls, js, L, c, W, n, kp, cnt);
  }
  return (int)cudaGetLastError();
}

// K6b. src: component pointers of the point table ([16, n] per component,
// row stride src_ld); packed: [n, 8 * components] int32 scratch; dst: of
// the N output lanes (dst_ld); sidx: the stable sort's int64 permutation of
// the N keys; C0: level 0's chunks (0: lanes in position order). Two
// launches: the table packed point-major, then the gather.
int zksc_sorted_gather(int g2, const void* const* src, long long src_ld, void* packed,
                       void* const* dst, long long dst_ld, const void* sidx, long long n,
                       long long N, long long C0, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (n <= 0 || (C0 && N != C0 * zksc::kScanSteps)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ncomp = g2 ? 6 : 3;
  zksc::pack_points_kernel<<<zksc::glue_grid(n), zksc::kGlueThreads, 0, st>>>(
      zksc::glue_in(src, src_ld), ncomp, (uint32_t*)packed, n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  zksc::sorted_gather_kernel<<<zksc::glue_grid(N), zksc::kGlueThreads, 0, st>>>(
      (const uint32_t*)packed, ncomp, zksc::glue_out(dst, dst_ld), (const long long*)sidx, n, N,
      C0);
  return (int)cudaGetLastError();
}

// K6c. in / out: T lanes (row strides in_ld, out_ld); runs: [16, B P]
// scratch for the runs' inclusive sums in their tiles (read when B > 1);
// runs of m lanes, B tiles of P = kGlueThreads / (threads a lane) runs (the
// caller's plan, ops/msm_glue.py:scan_plan). One launch when B == 1, else
// two.
int zksc_scan_top(int g2, int inclusive, const void* const* in, long long in_ld,
                  void* const* out, long long out_ld, void* const* runs, long long runs_ld,
                  long long T, int m, int B, void* stream) {
  if (T <= 0) return (int)cudaSuccess;
  const long long P = zksc::kGlueThreads / (g2 ? 2 : 1);
  if (m < 1 || B < 1 || B > P || (long long)B * P * m < T || ((long long)B - 1) * P * m >= T)
    return (int)cudaErrorInvalidValue;
  const zksc::InArrs i = zksc::glue_in(in, in_ld);
  const zksc::OutArrs o = zksc::glue_out(out, out_ld);
  const zksc::InArrs ri = zksc::glue_in((const void* const*)runs, runs_ld);
  const zksc::OutArrs ro = zksc::glue_out(runs, runs_ld);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(B), block(zksc::kGlueThreads);
  for (int totals = B > 1; totals >= 0; --totals) {
    if (g2)
      zksc::scan_top_kernel<Fp2h><<<grid, block, 0, st>>>(i, o, ri, ro, T, m, B, inclusive, totals);
    else
      zksc::scan_top_kernel<Fp><<<grid, block, 0, st>>>(i, o, ri, ro, T, m, B, inclusive, totals);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// K6d. n_levels levels, level l's six component pointers at
// level_ptrs[6 l .. 6 l + 5] with row stride level_ld[l], its position
// stride, chunks (0: position order) and lane count; cum: [segs, 2^c]
// int32 cumulative counts; pre: [16, segs] scratch for the segment
// prefixes; out: the 2^c * segs q-major bucket lanes. Two launches.
int zksc_bucket_boundaries(int g2, int n_levels, const void* const* level_ptrs,
                           const long long* level_ld, const long long* strides,
                           const long long* chunks, const long long* lanes, const void* cum,
                           void* const* pre, long long pre_ld, void* const* out,
                           long long out_ld, int c, long long segs, long long n, long long N,
                           void* stream) {
  if (n_levels < 1 || n_levels > zksc::kMaxLevels || c < 1 || c > 16 || segs < 1 || n < 1 ||
      N != segs * n)
    return (int)cudaErrorInvalidValue;
  zksc::Levels lv;
  for (int l = 0; l < zksc::kMaxLevels; ++l) {
    const bool used = l < n_levels;
    lv.arr[l] = zksc::glue_in(used ? level_ptrs + 6 * l : level_ptrs, used ? level_ld[l] : 0);
    lv.stride[l] = used ? strides[l] : 1;
    lv.chunks[l] = used ? chunks[l] : 0;
    lv.lanes[l] = used ? lanes[l] : 1;
    if (used && (lv.stride[l] < 1 || lv.lanes[l] < 1)) return (int)cudaErrorInvalidValue;
  }
  lv.count = n_levels;
  const zksc::OutArrs pw = zksc::glue_out(pre, pre_ld), o = zksc::glue_out(out, out_ld);
  const zksc::InArrs pr = zksc::glue_in((const void* const*)pre, pre_ld);
  cudaStream_t st = (cudaStream_t)stream;
  const long long tpl = g2 ? 2 : 1;
  const long long bucket_lanes = segs << c;
  if (g2)
    zksc::segment_prefix_kernel<Fp2h><<<zksc::glue_grid(segs * tpl), zksc::kGlueThreads, 0, st>>>(
        lv, pw, segs, n, N);
  else
    zksc::segment_prefix_kernel<Fp><<<zksc::glue_grid(segs * tpl), zksc::kGlueThreads, 0, st>>>(
        lv, pw, segs, n, N);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (g2)
    zksc::bucket_kernel<Fp2h><<<zksc::glue_grid(bucket_lanes * tpl), zksc::kGlueThreads, 0, st>>>(
        lv, pr, (const int*)cum, o, c, segs, n, N);
  else
    zksc::bucket_kernel<Fp><<<zksc::glue_grid(bucket_lanes * tpl), zksc::kGlueThreads, 0, st>>>(
        lv, pr, (const int*)cum, o, c, segs, n, N);
  return (int)cudaGetLastError();
}

}  // extern "C"

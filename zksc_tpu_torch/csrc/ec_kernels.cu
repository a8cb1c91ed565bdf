// Hand-written Hopper (sm_90a) kernels for the bucket MSM's point additions.
//
// K1 chunk_scan -- replaces the Pallas kernel zksc_tpu/ops/pallas_ec.py:
//    chunk_scan (body _scan_kernel): for each of C chunks of S lanes, a
//    sequential prefix sum under COMPLETE Jacobian addition, starting at the
//    identity; writes the scanned values (inclusive, or exclusive = the
//    accumulator before the add) and the per-chunk totals.
// K2 jac_add_n -- replaces zksc_tpu/ops/pallas_ec.py:jac_add_n (body
//    _add_kernel): elementwise P + Q over N lanes, complete (ec.jac_add) or
//    incomplete (ec.jac_add_incomplete).
// Both for G1 (Fp coordinates) and G2 (Fp2 coordinates).
//
// Tensor layout at the boundary: 16 x 16-bit limbs per field element,
// limb-major, stored as int32 (read here as uint32). A coordinate is one
// array (G1) or two component arrays c0, c1 (G2); limb k of lane i sits at
// ptr[k * ld + i], each operand with its own row stride ld, so the callers'
// views are read in place: the G2 folded [c0 | c1] layout (c1 = c0 + N),
// and the halving reduce's two halves of one array (K2). K1 works on the
// layout the MSM's scan holds, step-major (lane = step * C + chunk): the
// sorted gather writes level 0 that way, K1 writes each chunk total where
// the next level reads it, and the boundary gathers index it directly, so
// no transposed copy is made around K1 and every K1 access is coalesced.
//
// What bounds them on this card: integer multiply-adds, not bytes. One
// Montgomery product is ~258 IMAD issue slots (bn254.cuh); a point add is
// 16 products (G1), 11 where Q is affine, and three times that for G2 -- so
// a G1 K2 lane costs ~0.25 ns of IMAD at 16.7 T/s against ~0.17 ns for its
// 576 bytes at 3.35 TB/s. What the design does about it: the whole point
// formula stays in registers (K1 keeps the accumulator there across its S
// steps), so each input is read once and each output written once; the
// product is bn254.cuh's inlined carry-chain CIOS, the adds skip the
// products by an affine Q.z and return early on the identity; a G2 lane
// takes two threads (bn254.cuh Fp2h), which halves its registers (no
// spill) and doubles the threads of the small G2 launches, which are
// latency-bound. A block-stride loop covers any lane count, so no
// tile-multiple condition is left on the caller.
#include <cuda_runtime.h>

#include <cstdint>

#include "bn254.cuh"

namespace zksc {

constexpr int kThreads = 128;

// Lane s * C + c holds step s of chunk c (step-major), so the threads of a
// warp, one chunk each, read and write neighbouring words at every step.
// Chunk c's total goes to lane c, or, when the next level scans chunks of
// carry_steps totals, to that level's step-major lane
// (c % carry_steps) * (C / carry_steps) + c / carry_steps.
template <class F, bool INCLUSIVE>
__global__ void __launch_bounds__(kThreads) chunk_scan_kernel(InArrs in, OutArrs out,
                                                              OutArrs carry, int S,
                                                              long long C,
                                                              int carry_steps) {
  constexpr int T = kThreadsPerLane<F>;
  const size_t next_chunks = (size_t)C / carry_steps;
  for (size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x; g < (size_t)C * T;
       g += (size_t)gridDim.x * blockDim.x) {
    const size_t c = g / T;
    Jac<F> acc = jac_identity<F>();
    for (int s = 0; s < S; ++s) {
      const size_t i = (size_t)s * C + c;
      const Jac<F> p = load_point<F>(in, i);
      const Jac<F> sum = jac_add<F, true>(acc, p);
      store_point<F>(out, i, INCLUSIVE ? sum : acc);
      acc = sum;
    }
    store_point<F>(carry, (c % carry_steps) * next_chunks + c / carry_steps, acc);
  }
}

template <class F, bool COMPLETE>
__global__ void __launch_bounds__(kThreads) jac_add_kernel(InArrs P, InArrs Q, OutArrs R,
                                                           long long N) {
  constexpr int T = kThreadsPerLane<F>;
  for (size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x; g < (size_t)N * T;
       g += (size_t)gridDim.x * blockDim.x) {
    const size_t i = g / T;
    const Jac<F> a = load_point<F>(P, i);
    const Jac<F> b = load_point<F>(Q, i);
    store_point<F>(R, i, jac_add<F, COMPLETE>(a, b));
  }
}

// blocks for n threads; the block-stride loop covers the rest
inline unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  return (unsigned)blocks;
}

inline InArrs in_arrs(const void* const* p, long long ld) {
  InArrs a;
  for (int i = 0; i < 6; ++i) a.p[i] = (const uint32_t*)p[i];
  a.ld = ld;
  return a;
}

inline OutArrs out_arrs(void* const* p, long long ld) {
  OutArrs a;
  for (int i = 0; i < 6; ++i) a.p[i] = (uint32_t*)p[i];
  a.ld = ld;
  return a;
}

}  // namespace zksc

using zksc::Fp;
using zksc::Fp2h;

extern "C" {

// K1. in: component pointers (G1 x, y, z; G2 x0, x1, y0, y1, z0, z1) of
// step-major [16, S*C] arrays (lane s * C + c) with row stride in_ld; out:
// the same layout (out_ld); carry: [16, C] (carry_ld), in the order
// carry_steps selects (1: chunk order). Returns the cudaError_t of the
// launch.
int zksc_chunk_scan(int g2, int inclusive, const void* const* in, long long in_ld,
                    void* const* out, long long out_ld, void* const* carry,
                    long long carry_ld, int S, long long C, int carry_steps,
                    void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  if (carry_steps < 1 || C % carry_steps) return (int)cudaErrorInvalidValue;
  const zksc::InArrs i = zksc::in_arrs(in, in_ld);
  const zksc::OutArrs o = zksc::out_arrs(out, out_ld), k = zksc::out_arrs(carry, carry_ld);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(zksc::grid_for(g2 ? 2 * C : C)), block(zksc::kThreads);
  if (g2) {
    if (inclusive)
      zksc::chunk_scan_kernel<Fp2h, true><<<grid, block, 0, st>>>(i, o, k, S, C, carry_steps);
    else
      zksc::chunk_scan_kernel<Fp2h, false><<<grid, block, 0, st>>>(i, o, k, S, C, carry_steps);
  } else {
    if (inclusive)
      zksc::chunk_scan_kernel<Fp, true><<<grid, block, 0, st>>>(i, o, k, S, C, carry_steps);
    else
      zksc::chunk_scan_kernel<Fp, false><<<grid, block, 0, st>>>(i, o, k, S, C, carry_steps);
  }
  return (int)cudaGetLastError();
}

// K2. p, q, r: component pointers of [16, *] arrays, N lanes each, with
// their own row strides (for the folded G2 layout the caller passes
// c1 = c0 + N).
int zksc_jac_add_n(int g2, int complete, const void* const* p, long long p_ld,
                   const void* const* q, long long q_ld, void* const* r, long long r_ld,
                   long long N, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  const zksc::InArrs P = zksc::in_arrs(p, p_ld), Q = zksc::in_arrs(q, q_ld);
  const zksc::OutArrs R = zksc::out_arrs(r, r_ld);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(zksc::grid_for(g2 ? 2 * N : N)), block(zksc::kThreads);
  if (g2) {
    if (complete)
      zksc::jac_add_kernel<Fp2h, true><<<grid, block, 0, st>>>(P, Q, R, N);
    else
      zksc::jac_add_kernel<Fp2h, false><<<grid, block, 0, st>>>(P, Q, R, N);
  } else {
    if (complete)
      zksc::jac_add_kernel<Fp, true><<<grid, block, 0, st>>>(P, Q, R, N);
    else
      zksc::jac_add_kernel<Fp, false><<<grid, block, 0, st>>>(P, Q, R, N);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

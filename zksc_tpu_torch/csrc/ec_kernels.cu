// Hand-written Hopper (sm_90a) kernels for the bucket MSM's point additions.
//
// K1 chunk_scan -- replaces the Pallas kernel zksc_tpu/ops/pallas_ec.py:
//    chunk_scan (body _scan_kernel): for each of C lanes, a sequential
//    prefix sum over S steps under COMPLETE Jacobian addition, starting at
//    the identity; writes the scanned values (inclusive, or exclusive = the
//    accumulator before the add) and the per-lane totals.
// K2 jac_add_n -- replaces zksc_tpu/ops/pallas_ec.py:jac_add_n (body
//    _add_kernel): elementwise P + Q over N lanes, complete (ec.jac_add) or
//    incomplete (ec.jac_add_incomplete).
// Both for G1 (Fp coordinates) and G2 (Fp2 coordinates).
//
// Tensor layout at the boundary: 16 x 16-bit limbs per field element,
// limb-major, stored as int32 (read here as uint32). A coordinate is one
// array (G1) or two component arrays c0, c1 (G2); limb k of lane i sits at
// ptr[k * ld + i], so neighbouring threads touch neighbouring addresses.
// K1 takes step-major [S, 16, C] arrays (the JAX kernel's layout); K2 takes
// [16, ld] arrays, which lets it read the G2 folded [c0 | c1] layout in
// place (c1 pointer = c0 pointer + N, ld = 2N).
//
// What bounds them on this card: integer multiply-adds, not bytes. One
// Montgomery product is 8 x 8 + 8 x 8 32x32->64-bit multiply-adds (each two
// IMAD issue slots) ~ 258 IMAD; the raw point add is 16 products for G1 and
// 48 (16 Fp2 products of 3) for G2 -> ~4.1K / ~12.4K IMAD per add, against
// 576 / 1,152 bytes moved per K2 lane (two points in, one out). At 64
// IMAD/clk/SM x 132 SMs x 1.98 GHz (16.7 T/s) vs 3.35 TB/s that is ~0.25 ns
// of IMAD vs ~0.17 ns of bytes per G1 lane (G2: ~0.74 vs ~0.34 ns).
// What the design does about it: one thread per lane with the whole point
// formula in registers (K1 keeps the accumulator in registers across all S
// steps, so each input is read once and each output written once); the
// Montgomery product is one out-of-line CIOS routine on 32-bit words with
// 64-bit products (mul.wide / mad.hi), a quarter of the partial products of
// the 16-bit limb schoolbook the TPU needed. A block-stride loop covers any
// lane count, so no tile-multiple condition is left on the caller.
// Warp-cooperative limb products and shared-memory staging come later.
#include <cuda_runtime.h>

#include <cstdint>

#include "bn254.cuh"

namespace zksc {

template <class F, bool INCLUSIVE>
__global__ void __launch_bounds__(128) chunk_scan_kernel(InArrs in, OutArrs out, OutArrs carry,
                                                         int S, long long C) {
  const size_t ld = (size_t)C;
  const size_t step = 16 * (size_t)C;
  for (size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x; c < (size_t)C;
       c += (size_t)gridDim.x * blockDim.x) {
    Jac<F> acc = jac_identity<F>();
    for (int s = 0; s < S; ++s) {
      const Jac<F> p = load_point<F>(in, s * step + c, ld);
      const Jac<F> sum = jac_add<F, true>(acc, p);
      store_point<F>(out, s * step + c, ld, INCLUSIVE ? sum : acc);
      acc = sum;
    }
    store_point<F>(carry, c, ld, acc);
  }
}

template <class F, bool COMPLETE>
__global__ void __launch_bounds__(128) jac_add_kernel(InArrs P, InArrs Q, OutArrs R,
                                                      long long N, long long ld) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < (size_t)N;
       i += (size_t)gridDim.x * blockDim.x) {
    const Jac<F> a = load_point<F>(P, i, (size_t)ld);
    const Jac<F> b = load_point<F>(Q, i, (size_t)ld);
    store_point<F>(R, i, (size_t)ld, jac_add<F, COMPLETE>(a, b));
  }
}

constexpr int kThreads = 128;

inline unsigned grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;   // the block-stride loop covers the rest
  return (unsigned)blocks;
}

}  // namespace zksc

using zksc::Fp;
using zksc::Fp2;
using zksc::InArrs;
using zksc::OutArrs;

extern "C" {

// K1. in*/out*: [S, 16, C] int32 arrays; carry*: [16, C]. G1 uses the first
// three of each group (x, y, z), G2 all six (x0, x1, y0, y1, z0, z1).
// Returns the cudaError_t of cudaGetLastError() after the launch.
int zksc_chunk_scan(int g2, int inclusive,
                    const void* i0, const void* i1, const void* i2,
                    const void* i3, const void* i4, const void* i5,
                    void* o0, void* o1, void* o2, void* o3, void* o4, void* o5,
                    void* k0, void* k1, void* k2, void* k3, void* k4, void* k5,
                    int S, long long C, void* stream) {
  if (C <= 0) return (int)cudaSuccess;
  const InArrs in = {{(const uint32_t*)i0, (const uint32_t*)i1, (const uint32_t*)i2,
                      (const uint32_t*)i3, (const uint32_t*)i4, (const uint32_t*)i5}};
  const OutArrs out = {{(uint32_t*)o0, (uint32_t*)o1, (uint32_t*)o2,
                        (uint32_t*)o3, (uint32_t*)o4, (uint32_t*)o5}};
  const OutArrs carry = {{(uint32_t*)k0, (uint32_t*)k1, (uint32_t*)k2,
                          (uint32_t*)k3, (uint32_t*)k4, (uint32_t*)k5}};
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(zksc::grid_for(C)), block(zksc::kThreads);
  if (g2) {
    if (inclusive)
      zksc::chunk_scan_kernel<Fp2, true><<<grid, block, 0, st>>>(in, out, carry, S, C);
    else
      zksc::chunk_scan_kernel<Fp2, false><<<grid, block, 0, st>>>(in, out, carry, S, C);
  } else {
    if (inclusive)
      zksc::chunk_scan_kernel<Fp, true><<<grid, block, 0, st>>>(in, out, carry, S, C);
    else
      zksc::chunk_scan_kernel<Fp, false><<<grid, block, 0, st>>>(in, out, carry, S, C);
  }
  return (int)cudaGetLastError();
}

// K2. p*/q*/r*: component pointers of [16, ld] arrays, N lanes each (for the
// folded G2 layout the caller passes c1 = c0 + N and ld = 2N).
int zksc_jac_add_n(int g2, int complete,
                   const void* p0, const void* p1, const void* p2,
                   const void* p3, const void* p4, const void* p5,
                   const void* q0, const void* q1, const void* q2,
                   const void* q3, const void* q4, const void* q5,
                   void* r0, void* r1, void* r2, void* r3, void* r4, void* r5,
                   long long N, long long ld, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  const InArrs P = {{(const uint32_t*)p0, (const uint32_t*)p1, (const uint32_t*)p2,
                     (const uint32_t*)p3, (const uint32_t*)p4, (const uint32_t*)p5}};
  const InArrs Q = {{(const uint32_t*)q0, (const uint32_t*)q1, (const uint32_t*)q2,
                     (const uint32_t*)q3, (const uint32_t*)q4, (const uint32_t*)q5}};
  const OutArrs R = {{(uint32_t*)r0, (uint32_t*)r1, (uint32_t*)r2,
                      (uint32_t*)r3, (uint32_t*)r4, (uint32_t*)r5}};
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(zksc::grid_for(N)), block(zksc::kThreads);
  if (g2) {
    if (complete)
      zksc::jac_add_kernel<Fp2, true><<<grid, block, 0, st>>>(P, Q, R, N, ld);
    else
      zksc::jac_add_kernel<Fp2, false><<<grid, block, 0, st>>>(P, Q, R, N, ld);
  } else {
    if (complete)
      zksc::jac_add_kernel<Fp, true><<<grid, block, 0, st>>>(P, Q, R, N, ld);
    else
      zksc::jac_add_kernel<Fp, false><<<grid, block, 0, st>>>(P, Q, R, N, ld);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

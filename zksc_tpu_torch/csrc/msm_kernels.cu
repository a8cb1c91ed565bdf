// Hand-written Hopper (sm_90a) kernel for the double-and-add ladder MSM.
//
// K3 ladder -- replaces the Pallas kernel zksc_tpu/ops/pallas_msm.py:
//    msm_g1_pallas (body _ladder_tile_kernel). Each lane runs an MSB-first
//    double-and-add ladder, acc <- 2 acc, then acc <- acc + P_i where bit k
//    of s_i is set (complete addition, pallas_msm.py:33-38); then the lanes
//    of each group are reduced to one point inside the block (in place of
//    the in-tile pltpu.roll rounds). Instances for G1 (Fp) and G2 (Fp2).
//
// Modes, chosen by the caller (ops/msm_kernels.py):
//    group == 1  unreduced: per-lane s_i * P_i (the ladder of
//                ops/ec.py:scale_points, limb for limb);
//    group  > 1  reduced: the sum of each run of `group` lanes (a power of
//                two dividing the block), written to out[lane / group];
//                the wrapper relaunches with ladder = 0 (load P as the
//                accumulator, no ladder) until one point per segment is left.
// Bits are int32 0/1 at bits[k * bit_row + lane * bit_lane]: [n_bits, N]
// per lane (bit_row = N, bit_lane = 1) or one vector shared by every lane
// (bit_row = 1, bit_lane = 0), so scaling a batch by one scalar does not
// materialise [n_bits, N] bits.
//
// What bounds it on this card: integer multiply-adds. Per lane per bit a
// doubling is 7 Montgomery products and an addition 16, 11 where the
// lane's point is affine (G2: three base products each), ~258 IMAD slots
// per product (bn254.cuh's inlined product); the bytes are one read of
// each point and bit and one write per output. The design: one thread per
// lane with the accumulator and the lane's point in registers for the
// whole ladder (one read of the inputs, one write), so the kernel is pure
// arithmetic in between. Work the data does not need is skipped without
// changing a limb: the addition where the bit is 0 (its result is not
// selected), and the doubling while the accumulator is still the canonical
// identity (1, 1, 0), which doubles to itself. The block's reduction runs
// in shared memory (24.6 KB for G2). The grid covers any lane count; the
// ragged edge is masked.
#include <cuda_runtime.h>

#include <cstdint>

#include "bn254.cuh"

namespace zksc {

constexpr int kLadderThreads = 128;

struct Bits {
  const int32_t* p;
  long long row;
  long long lane;
};

template <class F>
__device__ __forceinline__ Jac<F> ladder(const Jac<F>& P, const Bits& b, size_t lane,
                                         int n_bits) {
  Jac<F> acc = jac_identity<F>();
  for (int k = n_bits - 1; k >= 0; --k) {
    if (!(f_is_zero(acc.z) && f_is_one(acc.x) && f_is_one(acc.y)))
      acc = jac_double(acc);
    if (b.p[(long long)k * b.row + (long long)lane * b.lane] != 0)
      acc = jac_add<F, true>(acc, P);
  }
  return acc;
}

template <class F>
__global__ void __launch_bounds__(kLadderThreads)
ladder_kernel(InArrs pts, Bits bits, int n_bits, int run_ladder, OutArrs out,
              long long N, int group) {
  __shared__ Jac<F> sh[kLadderThreads];
  const int t = threadIdx.x;
  const size_t lane = (size_t)blockIdx.x * kLadderThreads + t;
  Jac<F> acc = jac_identity<F>();
  if (lane < (size_t)N) {
    const Jac<F> P = load_point<F>(pts, lane);
    acc = run_ladder ? ladder<F>(P, bits, lane, n_bits) : P;
  }
  if (group > 1) {
    sh[t] = acc;
    __syncthreads();
    for (int s = group >> 1; s >= 1; s >>= 1) {
      // lanes whose offset in the group is below s add the lane s above:
      // the halving order of ops/msm_kernels.py:_grouped_reduce
      if ((t & (2 * s - 1)) < s) sh[t] = jac_add<F, true>(sh[t], sh[t + s]);
      __syncthreads();
    }
    acc = sh[t];
  }
  if (lane < (size_t)N && (t & (group - 1)) == 0)
    store_point<F>(out, lane / group, acc);
}

}  // namespace zksc

using zksc::Fp;
using zksc::Fp2;
using zksc::InArrs;
using zksc::OutArrs;

extern "C" {

// K3. p*: component pointers of [16, ld] point arrays, N lanes (G1 uses the
// first three; for the folded G2 layout the caller passes c1 = c0 + N).
// o*: the same for the [16, out_ld] output, N / group lanes. group: 1, or a
// power of two up to the block size (128). Returns the cudaError_t of
// cudaGetLastError() after the launch.
int zksc_ladder(int g2, int run_ladder, const void* bits, long long bit_row,
                long long bit_lane, int n_bits,
                const void* p0, const void* p1, const void* p2,
                const void* p3, const void* p4, const void* p5,
                void* o0, void* o1, void* o2, void* o3, void* o4, void* o5,
                long long N, long long ld, long long out_ld, int group,
                void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (group < 1 || group > zksc::kLadderThreads || (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  const InArrs P = {{(const uint32_t*)p0, (const uint32_t*)p1, (const uint32_t*)p2,
                     (const uint32_t*)p3, (const uint32_t*)p4, (const uint32_t*)p5}, ld};
  const OutArrs O = {{(uint32_t*)o0, (uint32_t*)o1, (uint32_t*)o2,
                      (uint32_t*)o3, (uint32_t*)o4, (uint32_t*)o5}, out_ld};
  const zksc::Bits b = {(const int32_t*)bits, bit_row, bit_lane};
  cudaStream_t st = (cudaStream_t)stream;
  const long long blocks = (N + zksc::kLadderThreads - 1) / zksc::kLadderThreads;
  const dim3 grid((unsigned)blocks), block(zksc::kLadderThreads);
  if (g2)
    zksc::ladder_kernel<Fp2><<<grid, block, 0, st>>>(P, b, n_bits, run_ladder, O, N, group);
  else
    zksc::ladder_kernel<Fp><<<grid, block, 0, st>>>(P, b, n_bits, run_ladder, O, N, group);
  return (int)cudaGetLastError();
}

}  // extern "C"

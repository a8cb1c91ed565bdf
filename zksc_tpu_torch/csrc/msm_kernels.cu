// Hand-written Hopper (sm_90a) kernel for the double-and-add ladder MSM.
//
// K3 ladder -- replaces the Pallas kernel zksc_tpu/ops/pallas_msm.py:
//    msm_g1_pallas (body _ladder_tile_kernel). Each lane runs an MSB-first
//    double-and-add ladder, acc <- 2 acc, then acc <- acc + P_i where bit k
//    of s_i is set (complete addition, pallas_msm.py:33-38); then the lanes
//    of each group are reduced to one point (in place of the in-tile
//    pltpu.roll rounds). G1 (Fp) and G2 (Fp2 as bn254.cuh's Fp2h: one lane
//    on a thread pair).
//
// Modes, chosen by the caller (ops/msm_kernels.py):
//    group == 1  unreduced: per-lane s_i * P_i (the ladder of
//                ops/ec.py:scale_points, limb for limb);
//    group  > 1  reduced (LANE layout only): the sum of each run of `group`
//                lanes (a power of two up to 128), a halving tree in the
//                block, written to out[lane / group]; the wrapper relaunches
//                with ladder = 0 (load P as the accumulator, no ladder)
//                until one point per segment is left.
// Bits are int32 0/1 at bits[k * bit_row + lane * bit_lane]: [n_bits, N]
// per lane (bit_row = N, bit_lane = 1) or one vector shared by every lane
// (bit_row = 1, bit_lane = 0), so scaling a batch by one scalar does not
// materialise [n_bits, N] bits.
//
// What bounds it on this card: integer multiply-adds, ~258 IMAD issue
// slots per Montgomery product (bn254.cuh's inlined product). Per lane per
// bit a doubling is 7 products and an addition 11 where the lane's point
// is affine (16 where it is not; G2: two base products per thread of the
// pair). The bytes are one read of each point and bit and one write per
// output. Two layouts of one kernel, picked from the shape by the wrapper:
//
//  LANE   one thread (G2: one pair) per lane, 128 lanes per block, the
//         accumulator and the lane's point in registers for the whole
//         ladder. Bound by IMAD issue once the card is full: the ceremony
//         scales 2^16-2^18 lanes by one shared scalar, every warp on the
//         same branch. The block reduces its groups in shared memory, so
//         this layout also runs the reductions.
//  SPLIT  a launch of a few thousand lanes fills a fraction of the card's
//         528 schedulers with one warp each, and a warp's ladder is then a
//         chain of dependent products: 254 bits x 18 products for the 128
//         lanes of a ladder-branch MSM, each product ~900 cycles of
//         latency where one warp cannot hide it. The products of a point
//         formula form a shallow graph -- a doubling is 3 levels deep
//         ({X 3X, Y^2, 2Y Z}, {B^2, 4X B, E^2}, {E (D - X3)}), an affine
//         add 5 -- so each lane gets four threads (G2: four thread pairs),
//         and at each level role j computes product j on operands it
//         selects by its role; the results go to every thread of the lane
//         by __shfl_sync within the lane's own threads. Every thread keeps
//         the full accumulator and point, so every branch (identity cases,
//         the complete add's doubling, the bit) is decided on values all
//         threads of the lane hold, and a shuffle never names a thread on
//         another path. The add's first products fill the doubling's spare
//         role slots, so a double-and-add step is 6 rounds deep instead of
//         18 products in a row. A warp whose points are all affine runs
//         rounds of up to three products, as jac_add skips the products by
//         Z2; one with a Jacobian point runs the Jacobian add's products in
//         the same six rounds, four at a time, so its lanes never split
//         over two paths. The products and their values are those of
//         jac_double / jac_add<F, true>, and every residue is canonical:
//         the limbs are LANE's. Blocks of 64 threads spread the warps over
//         the SMs, one warp per scheduler; the reduction is a LANE
//         relaunch over the lane results, in the same halving order. The
//         wrapper takes SPLIT up to 8,192 lanes, where LANE starts to fill
//         the card (measured crossover in ops/msm_kernels.py).
//
// Work the data does not need is skipped without changing a limb: the
// addition where the bit is 0 (its result is not selected), the doubling
// while the accumulator is still the canonical identity (1, 1, 0), which
// doubles to itself, and a lane whose point is the identity.
#include <cuda_runtime.h>

#include <cstdint>

#include "bn254.cuh"

namespace zksc {

constexpr int kLaneLanes = 128;      // lanes per LANE block: the largest group

struct Bits {
  const int32_t* p;
  long long row;
  long long lane;

  __device__ __forceinline__ bool at(int k, size_t i) const {
    return p[(long long)k * row + (long long)i * lane] != 0;
  }
};

template <class F>
__device__ __forceinline__ bool is_canonical_identity(const Jac<F>& a) {
  return f_is_zero(a.z) && f_is_one(a.x) && f_is_one(a.y);
}

// ---------------------------------------------------------------- LANE

template <class F>
__device__ __forceinline__ Jac<F> ladder(const Jac<F>& P, const Bits& b, size_t lane,
                                         int n_bits) {
  Jac<F> acc = jac_identity<F>();
  for (int k = n_bits - 1; k >= 0; --k) {
    if (!is_canonical_identity(acc)) acc = jac_double(acc);
    if (b.at(k, lane)) acc = jac_add<F, true>(acc, P);
  }
  return acc;
}

template <class F>
__global__ void __launch_bounds__(kLaneLanes * kThreadsPerLane<F>)
lane_kernel(InArrs pts, Bits bits, int n_bits, int run_ladder, OutArrs out,
            long long N, int group) {
  constexpr int T = kThreadsPerLane<F>;
  __shared__ Jac<F> sh[kLaneLanes * T];
  const int t = threadIdx.x;
  const int l = t / T;                       // lane in the block
  const size_t lane = (size_t)blockIdx.x * kLaneLanes + l;
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
      if ((l & (2 * s - 1)) < s) sh[t] = jac_add<F, true>(sh[t], sh[t + s * T]);
      __syncthreads();
    }
    acc = sh[t];
  }
  if (lane < (size_t)N && (l & (group - 1)) == 0)
    store_point<F>(out, lane / group, acc);
}

// ---------------------------------------------------------------- SPLIT

constexpr int kRoles = 4;            // threads (G2: thread pairs) per SPLIT lane
constexpr int kSplitThreads = 64;    // threads per SPLIT block

// The roles of one lane: threads base .. base + W - 1 of a warp, W = kRoles T
// (G2: role j is the pair base + 2j, base + 2j + 1, so bn254.cuh's pair
// shuffles stay inside the lane).
template <class F>
struct Roles {
  static constexpr int T = kThreadsPerLane<F>;
  static constexpr int W = kRoles * T;
  static constexpr int kLanesPerWarp = 32 / W;
  unsigned mask;
  int base, role;

  __device__ __forceinline__ Roles() {
    const int t = threadIdx.x & 31;
    base = t / W * W;
    role = (t - base) / T;
    mask = ((1u << W) - 1u) << base;
  }
  // the value `v` of role j's thread (G2: of the same component)
  __device__ __forceinline__ Fp from(const Fp& v, int j) const {
    const int src = base + j * T + (int)(threadIdx.x & (T - 1));
    Fp r;
#pragma unroll
    for (int i = 0; i < 8; ++i) r.w[i] = __shfl_sync(mask, v.w[i], src);
    return r;
  }
  __device__ __forceinline__ Fp2h from(const Fp2h& v, int j) const { return {from(v.v, j)}; }
};

__device__ __forceinline__ Fp f_sel(bool c, const Fp& a, const Fp& b) {
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = c ? a.w[i] : b.w[i];
  return r;
}
__device__ __forceinline__ Fp2h f_sel(bool c, const Fp2h& a, const Fp2h& b) {
  return {f_sel(c, a.v, b.v)};
}

// F as written, not deduced from a braced operand list
template <class T>
struct Same {
  using type = T;
};
template <class T>
using Arg = typename Same<T>::type;

// out[k] = a[k] b[k] for N <= kRoles independent products: role k computes
// product k (a role past N repeats product 0), and every result goes to
// every thread of the lane. All threads run the product, so the lane's
// threads never diverge. out may be longer than N; the rest is untouched.
template <int N, class F, int M>
__device__ __forceinline__ void products(const Roles<F>& g, F (&out)[M], const Arg<F> (&a)[N],
                                         const Arg<F> (&b)[N]) {
  static_assert(N <= kRoles && N <= M, "one round of products");
  F x = a[0], y = b[0];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    x = f_sel(g.role == j, a[j], x);
    y = f_sel(g.role == j, b[j], y);
  }
  const F p = f_mul(x, y);
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = g.from(p, j);
}

// The lane's point P (not O) and, for the Jacobian rounds, Z2^2 and Z2^3,
// made once per lane.
template <class F>
struct LanePoint {
  Jac<F> P;
  F zz, zzz;
};

// One ladder step: acc <- 2 acc unless acc is the canonical identity, then
// acc <- acc + P where the bit is set (jac_add<F, true>: P + O = P, O + P = P,
// P + P by the doubling). The doubling takes E = 3 X^2 as X (3X) and D =
// 2 ((X + B)^2 - X^2 - B^2) as (4X) B, the same values with no additions
// between its first two rounds. Six rounds of products: the doubling's three
// levels, with the add's Z1^2 in the second and U2, Z1^3 in the third; then
// {S2, HH, Z1 H}, {rr, HHH, V}, {r (V - X3), S1 HHH}. With JAC the
// Jacobian add's U1 = X1 Z2^2 joins the third round, S1 = Y1 Z2^3 the
// fourth, and Z3 = Z1 (Z2 H) the fifth (four products a round); without,
// P is affine (Z2 = one): U1 = X1, S1 = Y1, Z3 = Z1 H, as jac_add skips
// them. Every value is a canonical residue, so Z1 (Z2 H) has the limbs of
// jac_add's (Z1 Z2) H.
template <class F, bool JAC>
__device__ __forceinline__ void split_step(const Roles<F>& g, Jac<F>& acc,
                                           const LanePoint<F>& L, bool add) {
  if (is_canonical_identity(acc)) {
    if (add) acc = L.P;
    return;
  }
  const Jac<F>& P = L.P;
  const F x2 = f_add(acc.x, acc.x);
  F l1[3], l2[4];
  products<3>(g, l1, {acc.x, acc.y, f_add(acc.y, acc.y)}, {f_add(x2, acc.x), acc.y, acc.z});
  const F& E = l1[0];                                              // 3 X^2
  const F& B = l1[1];
  const F& Z1 = l1[2];
  products<4>(g, l2, {B, f_add(x2, x2), E, Z1}, {B, B, E, Z1});    // C, D, E^2, Z1Z1
  const F& D = l2[1];                                              // 4 X B
  const F X1 = f_sub(l2[2], f_add(D, D));
  F l3[4];                                                          // ., U2, Z1^3, U1
  if constexpr (JAC) {
    products<4>(g, l3, {E, P.x, Z1, X1}, {f_sub(D, X1), l2[3], l2[3], L.zz});
  } else {
    products<3>(g, l3, {E, P.x, Z1}, {f_sub(D, X1), l2[3], l2[3]});
    l3[3] = X1;
  }
  const F C2 = f_add(l2[0], l2[0]);
  const F C4 = f_add(C2, C2);
  const F Y1 = f_sub(l3[0], f_add(C4, C4));
  acc = {X1, Y1, Z1};
  if (!add) return;
  if (f_is_zero(Z1)) {                       // 2 acc = O
    acc = P;
    return;
  }
  const F& U1 = l3[3];
  const F H = f_sub(l3[1], U1);
  F l4[4], l5[4], l6[2];                                            // S2, HH, ., S1
  if constexpr (JAC) {
    products<4>(g, l4, {P.y, H, P.z, Y1}, {l3[2], H, H, L.zzz});   // ., ., Z2 H, .
  } else {
    products<3>(g, l4, {P.y, H, Z1}, {l3[2], H, H});           // ., ., Z3
    l4[3] = Y1;
  }
  const F& S1 = l4[3];
  const F r = f_sub(l4[0], S1);
  if (f_is_zero(H) && f_is_zero(r)) {
    acc = jac_double(acc);                   // acc == P: every thread holds it
    return;
  }
  if constexpr (JAC) {                                              // rr, HHH, V, Z3
    products<4>(g, l5, {r, H, U1, Z1}, {r, l4[1], l4[1], l4[2]});
  } else {
    products<3>(g, l5, {r, H, U1}, {r, l4[1], l4[1]});
    l5[3] = l4[2];
  }
  const F X3 = f_sub(f_sub(l5[0], l5[1]), f_add(l5[2], l5[2]));
  products<2>(g, l6, {r, S1}, {f_sub(l5[2], X3), l5[1]});
  acc = {X3, f_sub(l6[0], l6[1]), l5[3]};
}

template <class F, bool JAC>
__device__ __forceinline__ Jac<F> split_ladder(const Roles<F>& g, const LanePoint<F>& L,
                                               const Bits& b, size_t lane, int n_bits) {
  Jac<F> acc = jac_identity<F>();
  for (int k = n_bits - 1; k >= 0; --k) split_step<F, JAC>(g, acc, L, b.at(k, lane));
  return acc;
}

template <class F>
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(InArrs pts, Bits bits, int n_bits, OutArrs out, long long N) {
  const Roles<F> g;
  const size_t warp = ((size_t)blockIdx.x * kSplitThreads + threadIdx.x) / 32;
  const size_t lane = warp * Roles<F>::kLanesPerWarp + (threadIdx.x & 31) / Roles<F>::W;
  const bool valid = lane < (size_t)N;       // whole lanes: W divides 32
  LanePoint<F> L;
  L.P = jac_identity<F>();
  if (valid) L.P = load_point<F>(pts, lane);
  const bool live = !f_is_zero(L.P.z);
  // a warp takes the Jacobian rounds if one of its points is not affine
  const bool jac = __any_sync(0xffffffffu, live && !f_is_one(L.P.z));
  if (!valid) return;
  Jac<F> acc = jac_identity<F>();
  if (live) {
    if (jac) {
      F z[1];
      products<1>(g, z, {L.P.z}, {L.P.z});
      L.zz = z[0];
      products<1>(g, z, {L.P.z}, {L.zz});
      L.zzz = z[0];
      acc = split_ladder<F, true>(g, L, bits, lane, n_bits);
    } else {
      acc = split_ladder<F, false>(g, L, bits, lane, n_bits);
    }
  }
  if (g.role == 0) store_point<F>(out, lane, acc);
}

}  // namespace zksc

using zksc::Fp;
using zksc::Fp2h;
using zksc::InArrs;
using zksc::OutArrs;

extern "C" {

// K3. layout: 0 LANE, 1 SPLIT (group 1 and run_ladder 1 only).
// p*: component pointers of [16, ld] point arrays, N lanes (G1 uses the
// first three; for the folded G2 layout the caller passes c1 = c0 + N).
// o*: the same for the [16, out_ld] output, N / group lanes. group: 1, or a
// power of two up to 128. Returns the cudaError_t of cudaGetLastError()
// after the launch.
int zksc_ladder(int layout, int g2, int run_ladder, const void* bits, long long bit_row,
                long long bit_lane, int n_bits,
                const void* p0, const void* p1, const void* p2,
                const void* p3, const void* p4, const void* p5,
                void* o0, void* o1, void* o2, void* o3, void* o4, void* o5,
                long long N, long long ld, long long out_ld, int group,
                void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (group < 1 || group > zksc::kLaneLanes || (group & (group - 1)))
    return (int)cudaErrorInvalidValue;
  if (layout != 0 && (group != 1 || !run_ladder)) return (int)cudaErrorInvalidValue;
  const InArrs P = {{(const uint32_t*)p0, (const uint32_t*)p1, (const uint32_t*)p2,
                     (const uint32_t*)p3, (const uint32_t*)p4, (const uint32_t*)p5}, ld};
  const OutArrs O = {{(uint32_t*)o0, (uint32_t*)o1, (uint32_t*)o2,
                      (uint32_t*)o3, (uint32_t*)o4, (uint32_t*)o5}, out_ld};
  const zksc::Bits b = {(const int32_t*)bits, bit_row, bit_lane};
  cudaStream_t st = (cudaStream_t)stream;
  if (layout == 0) {
    const dim3 grid((unsigned)((N + zksc::kLaneLanes - 1) / zksc::kLaneLanes));
    const dim3 block(zksc::kLaneLanes * (g2 ? 2 : 1));
    if (g2)
      zksc::lane_kernel<Fp2h><<<grid, block, 0, st>>>(P, b, n_bits, run_ladder, O, N, group);
    else
      zksc::lane_kernel<Fp><<<grid, block, 0, st>>>(P, b, n_bits, run_ladder, O, N, group);
  } else if (layout == 1) {
    const long long lanes = zksc::kSplitThreads / 32 *
                            (g2 ? zksc::Roles<Fp2h>::kLanesPerWarp : zksc::Roles<Fp>::kLanesPerWarp);
    const dim3 grid((unsigned)((N + lanes - 1) / lanes)), block(zksc::kSplitThreads);
    if (g2)
      zksc::split_kernel<Fp2h><<<grid, block, 0, st>>>(P, b, n_bits, O, N);
    else
      zksc::split_kernel<Fp><<<grid, block, 0, st>>>(P, b, n_bits, O, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

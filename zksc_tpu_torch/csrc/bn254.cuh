// BN254 base-field arithmetic for the hand-written Hopper kernels.
//
// Fp elements live in registers as 8 x 32-bit little-endian words in
// Montgomery form with R = 2^256 -- the same R as the 16 x 16-bit limbs at
// the tensor boundary (fields/limb.py), so packing two limbs per word gives
// the same Montgomery residue. Every operation returns the canonical
// representative in [0, p), hence results unpack to exactly the limbs the
// plain PyTorch path (and the JAX reference) produce.
//
// Fp2 = Fp[i]/(i^2 + 1) is a pair of Fp; its product uses three base
// products (Karatsuba), the same values as ops/ec.py:Fp2Ops.mul_many.
//
// No PyTorch header is included anywhere in csrc/: the kernels are built
// by one plain nvcc call into a shared library with a C interface.
#pragma once

#include <cstddef>
#include <cstdint>

namespace zksc {

// p, little-endian 32-bit words
__device__ __constant__ uint32_t kP[8] = {
    0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
// R mod p: 1 in Montgomery form
__device__ __constant__ uint32_t kOne[8] = {
    0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
    0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
// -p^-1 mod 2^32
constexpr uint32_t kNP0 = 0xe4866389u;

struct Fp {
  uint32_t w[8];
};

struct Fp2 {
  Fp c0, c1;
};

__device__ __forceinline__ Fp fp_zero() {
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = 0u;
  return r;
}

__device__ __forceinline__ Fp fp_one() {
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = kOne[i];
  return r;
}

__device__ __forceinline__ bool fp_is_zero(const Fp& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.w[i];
  return acc == 0u;
}

// a - p when (hi != 0 or a >= p), else a. Requires a + hi * 2^256 < 2p.
__device__ __forceinline__ Fp fp_reduce_once(const Fp& a, uint32_t hi) {
  Fp d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t t = (uint64_t)a.w[i] - kP[i] - borrow;
    d.w[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  return (hi != 0u || borrow == 0u) ? d : a;
}

__device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b) {
  Fp s;
  uint32_t c = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t t = (uint64_t)a.w[i] + b.w[i] + c;
    s.w[i] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
  return fp_reduce_once(s, c);
}

__device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b) {
  Fp d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t t = (uint64_t)a.w[i] - b.w[i] - borrow;
    d.w[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  const uint32_t mask = 0u - borrow;     // add p back on underflow
  uint32_t c = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t t = (uint64_t)d.w[i] + (kP[i] & mask) + c;
    d.w[i] = (uint32_t)t;
    c = (uint32_t)(t >> 32);
  }
  return d;
}

// Montgomery product a * b * 2^-256 mod p (CIOS over 32-bit words).
// Kept out of line: every point formula calls it 16-48 times, and inlining
// each instance would multiply the build time and the register pressure.
__device__ __noinline__ Fp fp_mul(const Fp a, const Fp b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * kNP0;
    s = (uint64_t)m * kP[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)m * kP[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = t[i];
  return fp_reduce_once(r, t[8]);
}

// ---- the generic field interface the point formulas are written against

__device__ __forceinline__ Fp f_add(const Fp& a, const Fp& b) { return fp_add(a, b); }
__device__ __forceinline__ Fp f_sub(const Fp& a, const Fp& b) { return fp_sub(a, b); }
__device__ __forceinline__ Fp f_mul(const Fp& a, const Fp& b) { return fp_mul(a, b); }
__device__ __forceinline__ bool f_is_zero(const Fp& a) { return fp_is_zero(a); }
__device__ __forceinline__ void f_set_one(Fp& a) { a = fp_one(); }
__device__ __forceinline__ void f_set_zero(Fp& a) { a = fp_zero(); }

__device__ __forceinline__ Fp2 f_add(const Fp2& a, const Fp2& b) {
  return {fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
}
__device__ __forceinline__ Fp2 f_sub(const Fp2& a, const Fp2& b) {
  return {fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
}
__device__ __forceinline__ Fp2 f_mul(const Fp2& a, const Fp2& b) {
  const Fp t0 = fp_mul(a.c0, b.c0);
  const Fp t1 = fp_mul(a.c1, b.c1);
  const Fp t2 = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
  return {fp_sub(t0, t1), fp_sub(fp_sub(t2, t0), t1)};
}
__device__ __forceinline__ bool f_is_zero(const Fp2& a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}
__device__ __forceinline__ void f_set_one(Fp2& a) { a.c0 = fp_one(); a.c1 = fp_zero(); }
__device__ __forceinline__ void f_set_zero(Fp2& a) { a.c0 = fp_zero(); a.c1 = fp_zero(); }

// ---- Jacobian points (identity: Z == 0), BN254 a = 0

template <class F>
struct Jac {
  F x, y, z;
};

template <class F>
__device__ __forceinline__ Jac<F> jac_identity() {
  Jac<F> r;
  f_set_one(r.x);
  f_set_one(r.y);
  f_set_zero(r.z);
  return r;
}

// 2P; the formula of ops/ec.py:jac_double (complete for Z = 0).
template <class F>
__device__ __forceinline__ Jac<F> jac_double(const Jac<F>& P) {
  const F A = f_mul(P.x, P.x);
  const F B = f_mul(P.y, P.y);
  Jac<F> R;
  R.z = f_mul(f_add(P.y, P.y), P.z);
  const F xb = f_add(P.x, B);
  const F E = f_add(f_add(A, A), A);
  const F C = f_mul(B, B);
  const F t = f_mul(xb, xb);
  const F Fq = f_mul(E, E);
  const F D2 = f_sub(f_sub(t, A), C);
  const F D = f_add(D2, D2);
  R.x = f_sub(Fq, f_add(D, D));
  const F C2 = f_add(C, C);
  const F C4 = f_add(C2, C2);
  const F C8 = f_add(C4, C4);
  R.y = f_sub(f_mul(E, f_sub(D, R.x)), C8);
  return R;
}

// P + Q with the formula of ops/ec.py:_add_raw, then the reference's case
// selection: Q = O -> P (takes precedence), P = O -> Q, and, when COMPLETE,
// P == Q -> 2P. P = -Q falls out of the raw formula as Z3 = 0. With
// COMPLETE false (ec.jac_add_incomplete) P == Q gives the raw (0, 0, 0).
// The raw formula is evaluated on every lane, as the reference does.
template <class F, bool COMPLETE>
__device__ __forceinline__ Jac<F> jac_add(const Jac<F>& P, const Jac<F>& Q) {
  const F Z1Z1 = f_mul(P.z, P.z);
  const F Z2Z2 = f_mul(Q.z, Q.z);
  const F U1 = f_mul(P.x, Z2Z2);
  const F U2 = f_mul(Q.x, Z1Z1);
  const F S1 = f_mul(P.y, f_mul(Q.z, Z2Z2));
  const F S2 = f_mul(Q.y, f_mul(P.z, Z1Z1));
  const F H = f_sub(U2, U1);
  const F r = f_sub(S2, S1);
  const F HH = f_mul(H, H);
  const F rr = f_mul(r, r);
  const F HHH = f_mul(H, HH);
  const F V = f_mul(U1, HH);
  Jac<F> R;
  R.z = f_mul(f_mul(P.z, Q.z), H);
  R.x = f_sub(f_sub(rr, HHH), f_add(V, V));
  R.y = f_sub(f_mul(r, f_sub(V, R.x)), f_mul(S1, HHH));
  const bool p_inf = f_is_zero(P.z);
  const bool q_inf = f_is_zero(Q.z);
  if (q_inf) return P;
  if (p_inf) return Q;
  if (COMPLETE && f_is_zero(H) && f_is_zero(r)) return jac_double(P);
  return R;
}

// ---- the tensor boundary: 16 x 16-bit limbs per Fp, limb-major int32
// arrays (read as uint32). Limb k of lane i sits at ptr[k * ld + i]; a G2
// coordinate is two component arrays c0, c1.

struct InArrs {
  const uint32_t* p[6];   // G1: x, y, z; G2: x0, x1, y0, y1, z0, z1
};

struct OutArrs {
  uint32_t* p[6];
};

__device__ __forceinline__ Fp load_fp(const uint32_t* a, size_t idx, size_t ld) {
  Fp r;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    r.w[k] = a[idx + (size_t)(2 * k) * ld] | (a[idx + (size_t)(2 * k + 1) * ld] << 16);
  return r;
}

__device__ __forceinline__ void store_fp(uint32_t* a, size_t idx, size_t ld, const Fp& v) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[idx + (size_t)(2 * k) * ld] = v.w[k] & 0xFFFFu;
    a[idx + (size_t)(2 * k + 1) * ld] = v.w[k] >> 16;
  }
}

__device__ __forceinline__ void load_coord(Fp& f, const InArrs& a, int c, size_t idx, size_t ld) {
  f = load_fp(a.p[c], idx, ld);
}
__device__ __forceinline__ void load_coord(Fp2& f, const InArrs& a, int c, size_t idx, size_t ld) {
  f.c0 = load_fp(a.p[2 * c], idx, ld);
  f.c1 = load_fp(a.p[2 * c + 1], idx, ld);
}
__device__ __forceinline__ void store_coord(const OutArrs& a, int c, size_t idx, size_t ld, const Fp& f) {
  store_fp(a.p[c], idx, ld, f);
}
__device__ __forceinline__ void store_coord(const OutArrs& a, int c, size_t idx, size_t ld, const Fp2& f) {
  store_fp(a.p[2 * c], idx, ld, f.c0);
  store_fp(a.p[2 * c + 1], idx, ld, f.c1);
}

template <class F>
__device__ __forceinline__ Jac<F> load_point(const InArrs& a, size_t idx, size_t ld) {
  Jac<F> P;
  load_coord(P.x, a, 0, idx, ld);
  load_coord(P.y, a, 1, idx, ld);
  load_coord(P.z, a, 2, idx, ld);
  return P;
}

template <class F>
__device__ __forceinline__ void store_point(const OutArrs& a, size_t idx, size_t ld, const Jac<F>& P) {
  store_coord(a, 0, idx, ld, P.x);
  store_coord(a, 1, idx, ld, P.y);
  store_coord(a, 2, idx, ld, P.z);
}

}  // namespace zksc

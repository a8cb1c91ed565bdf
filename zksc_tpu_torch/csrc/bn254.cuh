// BN254 field arithmetic and Jacobian point formulas for the hand-written
// Hopper kernels (K1, K2 in ec_kernels.cu; K3 in msm_kernels.cu; the
// Groth16 H kernels K0, K4, K5 in h_kernels.cu).
//
// Field elements live in registers as 8 x 32-bit little-endian words in
// Montgomery form with R = 2^256 -- the same R as the 16 x 16-bit limbs at
// the tensor boundary (fields/limb.py), so packing two limbs per word gives
// the same Montgomery residue. Every operation returns the canonical
// representative in [0, m), hence results unpack to exactly the limbs the
// plain PyTorch path (and the JAX reference) produce. The element type
// names its modulus: Fp (the base field p: point coordinates) or Fr (the
// scalar field r: the Groth16 quotient); the arithmetic is one template
// over both (Field<E> holds the modulus' index and -m^-1 mod 2^32), so K1-K3
// compile to the code they had when the product was fixed to p.
//
// What bounds the point kernels: 32-bit integer multiply-adds. The design
// of this file:
//  - mont_mul is CIOS over 32-bit words written as PTX carry chains
//    (mad.lo.cc / madc.hi.cc / addc) in the even/odd split-accumulator
//    form: each chain adds four whole products whose low and high words
//    sit side by side, which ptxas fuses into wide multiply-adds with carry
//    (IMAD.WIDE.U32.X). Each chain is one asm block (the carry flag does
//    not live from one asm statement to the next). The product is inlined,
//    so ptxas schedules the independent products of a point formula (Z1Z1
//    with U2's operands, HH with rr, ...) side by side and an add costs
//    its critical path, not the sum of its products.
//  - Fp2 as Fp2h: one component per thread of an adjacent lane pair
//    (even thread c0, odd thread c1): add and sub are per component, a
//    product is the schoolbook pair c0 = a0 b0 - a1 b1 (even),
//    c1 = a0 b1 + a1 b0 (odd) with the partner's operands fetched by
//    __shfl_xor_sync(pair, ., 1): two base products per thread, and half
//    the registers of an Fp2 held in one thread (K1, K2, K3). All residues
//    are canonical, so it equals the plain path's Karatsuba limb for limb.
//    Zero and one tests combine both threads, so every branch is uniform
//    over the pair.
//  - jac_add returns P or Q outright where the other is the identity, and
//    skips the five products by Z2 where Q is affine (Z2 = Montgomery one:
//    Z2Z2 = 1, U1 = X1, S1 = Y1, Z1 Z2 = Z1; 11 products instead of 16): a
//    Montgomery product by R mod p returns its canonical input, so the
//    limbs are unchanged.
//
// No PyTorch header is included anywhere in csrc/: the kernels are built
// by one plain nvcc call into a shared library with a C interface.
#pragma once

#include <cstddef>
#include <cstdint>

namespace zksc {

// the moduli p (Fp) and r (Fr), little-endian 32-bit words
__device__ __constant__ uint32_t kModulus[2][8] = {
    {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u}};
// R mod m: 1 in Montgomery form
__device__ __constant__ uint32_t kMontOne[2][8] = {
    {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
     0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
     0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}};

struct Fp {
  uint32_t w[8];
};

struct Fr {
  uint32_t w[8];
};

// the modulus of an element type: its row of kModulus / kMontOne and
// -m^-1 mod 2^32
template <class E>
struct Field;
template <>
struct Field<Fp> {
  static constexpr int id = 0;
  static constexpr uint32_t np0 = 0xe4866389u;
};
template <>
struct Field<Fr> {
  static constexpr int id = 1;
  static constexpr uint32_t np0 = 0xefffffffu;
};

template <class E = Fp>
__device__ __forceinline__ E elem_zero() {
  E r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = 0u;
  return r;
}

template <class E = Fp>
__device__ __forceinline__ E elem_one() {
  E r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = kMontOne[Field<E>::id][i];
  return r;
}

template <class E>
__device__ __forceinline__ bool elem_is_zero(const E& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.w[i];
  return acc == 0u;
}

template <class E>
__device__ __forceinline__ bool elem_is_one(const E& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.w[i] ^ kMontOne[Field<E>::id][i];
  return acc == 0u;
}

template <class E>
__device__ __forceinline__ void load_modulus(uint32_t (&p)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) p[i] = kModulus[Field<E>::id][i];
}

// ---- carry chains (one asm block each)

// c[0..7] += x0 b + x1 b 2^64 + x2 b 2^128 + x3 b 2^192 (each product's
// low and high words side by side, so ptxas fuses each pair into one wide
// multiply-add with carry); the carry out is added to c[8].
__device__ __forceinline__ void mac4(uint32_t (&c)[9], uint32_t x0, uint32_t x1,
                                     uint32_t x2, uint32_t x3, uint32_t b) {
  asm volatile(
      "mad.lo.cc.u32  %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32       %8, %8, 0;"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3]), "+r"(c[4]), "+r"(c[5]),
        "+r"(c[6]), "+r"(c[7]), "+r"(c[8])
      : "r"(x0), "r"(x1), "r"(x2), "r"(x3), "r"(b));
}

// e = (e >> 32) + o over nine words.
__device__ __forceinline__ void shift_merge(uint32_t (&e)[9], const uint32_t (&o)[9]) {
  asm volatile(
      "add.cc.u32  %0, %1, %9;\n\t"
      "addc.cc.u32 %1, %2, %10;\n\t"
      "addc.cc.u32 %2, %3, %11;\n\t"
      "addc.cc.u32 %3, %4, %12;\n\t"
      "addc.cc.u32 %4, %5, %13;\n\t"
      "addc.cc.u32 %5, %6, %14;\n\t"
      "addc.cc.u32 %6, %7, %15;\n\t"
      "addc.cc.u32 %7, %8, %16;\n\t"
      "addc.u32    %8, %17, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]),
        "+r"(e[6]), "+r"(e[7]), "+r"(e[8])
      : "r"(o[0]), "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]),
        "r"(o[6]), "r"(o[7]), "r"(o[8]));
}

// d = a - b over 8 words; returns 0xffffffff on borrow, else 0.
__device__ __forceinline__ uint32_t sub8(uint32_t (&d)[8], const uint32_t (&a)[8],
                                         const uint32_t (&b)[8]) {
  uint32_t bw = 0u;
  asm volatile(
      "sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %8, %8;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]),
        "=r"(d[6]), "=r"(d[7]), "+r"(bw)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return bw;
}

// d = a + b over 8 words, the carry out dropped (callers keep sums < 2^256).
__device__ __forceinline__ void add8(uint32_t (&d)[8], const uint32_t (&a)[8],
                                     const uint32_t (&b)[8]) {
  asm volatile(
      "add.cc.u32  %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]),
        "=r"(d[6]), "=r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// ---- Fp and Fr (m: the element type's modulus, p or r; both < 2^254)

// t in [0, 2m) -> canonical t mod m.
template <class E>
__device__ __forceinline__ E reduce_once(const uint32_t (&t)[8]) {
  uint32_t p[8];
  load_modulus<E>(p);
  E d;
  const uint32_t bw = sub8(d.w, t, p);
#pragma unroll
  for (int i = 0; i < 8; ++i) d.w[i] = bw ? t[i] : d.w[i];
  return d;
}

template <class E>
__device__ __forceinline__ E mod_add(const E& a, const E& b) {
  uint32_t s[8];
  add8(s, a.w, b.w);                     // < 2m < 2^255: no carry out
  return reduce_once<E>(s);
}

template <class E>
__device__ __forceinline__ E mod_sub(const E& a, const E& b) {
  E d;
  const uint32_t bw = sub8(d.w, a.w, b.w);
  uint32_t q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = kModulus[Field<E>::id][i] & bw;   // add m back on underflow
  E r;
  add8(r.w, d.w, q);
  return r;
}

// Montgomery product a * b * 2^-256 mod m: CIOS over 32-bit words with
// split accumulators. Per word b_i the running sum T = E + 2^32 O takes
// a b_i and q m (q = T * -m^-1 mod 2^32), the even-indexed words of a and
// m into E and the odd-indexed ones into O, four chains of four products;
// then T / 2^32 = (E >> 32) + O becomes the next E. T stays below 2m
// between words, so nine words never overflow.
template <class E>
__device__ __forceinline__ E mont_mul(const E& a, const E& b) {
  uint32_t p[8];
  load_modulus<E>(p);
  uint32_t e[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) e[i] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t o[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) o[k] = 0u;
    mac4(e, a.w[0], a.w[2], a.w[4], a.w[6], b.w[i]);
    mac4(o, a.w[1], a.w[3], a.w[5], a.w[7], b.w[i]);
    const uint32_t m = e[0] * Field<E>::np0;
    mac4(e, p[0], p[2], p[4], p[6], m);          // e[0] becomes 0
    mac4(o, p[1], p[3], p[5], p[7], m);
    shift_merge(e, o);
  }
  uint32_t r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = e[i];
  return reduce_once<E>(r);
}

// ---- Fp2h: one component of an Fp2 = Fp[i]/(i^2 + 1) per thread of an
// adjacent lane pair (threads 2k, 2k + 1 of a warp; the even one holds c0).
// Callers keep both threads of a pair on the same path.

struct Fp2h {
  Fp v;
};

__device__ __forceinline__ bool pair_odd() { return threadIdx.x & 1u; }
__device__ __forceinline__ unsigned pair_mask() { return 3u << (threadIdx.x & 30u); }

__device__ __forceinline__ Fp pair_swap(const Fp& a) {
  const unsigned mask = pair_mask();
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.w[i] = __shfl_xor_sync(mask, a.w[i], 1);
  return r;
}

// true on both threads iff it holds on both
__device__ __forceinline__ bool pair_all(bool b) {
  return (__shfl_xor_sync(pair_mask(), (int)b, 1) != 0) && b;
}

// ---- the generic field interface the point formulas are written against

__device__ __forceinline__ Fp f_add(const Fp& a, const Fp& b) { return mod_add(a, b); }
__device__ __forceinline__ Fp f_sub(const Fp& a, const Fp& b) { return mod_sub(a, b); }
__device__ __forceinline__ Fp f_mul(const Fp& a, const Fp& b) { return mont_mul(a, b); }
__device__ __forceinline__ bool f_is_zero(const Fp& a) { return elem_is_zero(a); }
__device__ __forceinline__ bool f_is_one(const Fp& a) { return elem_is_one(a); }
__device__ __forceinline__ void f_set_one(Fp& a) { a = elem_one(); }
__device__ __forceinline__ void f_set_zero(Fp& a) { a = elem_zero(); }

__device__ __forceinline__ Fp2h f_add(const Fp2h& a, const Fp2h& b) { return {mod_add(a.v, b.v)}; }
__device__ __forceinline__ Fp2h f_sub(const Fp2h& a, const Fp2h& b) { return {mod_sub(a.v, b.v)}; }
// even: c0 = a0 b0 - a1 b1; odd: c1 = a0 b1 + a1 b0
__device__ __forceinline__ Fp2h f_mul(const Fp2h& a, const Fp2h& b) {
  const bool odd = pair_odd();
  const Fp ao = pair_swap(a.v);
  const Fp bo = pair_swap(b.v);
  const Fp x = mont_mul(odd ? ao : a.v, b.v);
  const Fp y = mont_mul(odd ? a.v : ao, bo);
  return {odd ? mod_add(x, y) : mod_sub(x, y)};
}
__device__ __forceinline__ bool f_is_zero(const Fp2h& a) { return pair_all(elem_is_zero(a.v)); }
__device__ __forceinline__ bool f_is_one(const Fp2h& a) {
  return pair_all(pair_odd() ? elem_is_zero(a.v) : elem_is_one(a.v));
}
__device__ __forceinline__ void f_set_one(Fp2h& a) { a.v = pair_odd() ? elem_zero() : elem_one(); }
__device__ __forceinline__ void f_set_zero(Fp2h& a) { a.v = elem_zero(); }

// threads that hold one lane's element
template <class F>
constexpr int kThreadsPerLane = 1;
template <>
constexpr int kThreadsPerLane<Fp2h> = 2;

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

// P + Q with the formula of ops/ec.py:_add_raw and the reference's case
// selection: Q = O -> P (takes precedence), P = O -> Q, and, when COMPLETE,
// H = r = 0 (P == Q) -> 2P. P = -Q falls out of the raw formula as Z3 = 0.
// With COMPLETE false (ec.jac_add_incomplete) P == Q gives the raw
// (0, 0, 0). The identity cases return before any product; where Q is
// affine the products by Z2 are skipped (same limbs, see the file head).
template <class F, bool COMPLETE>
__device__ __forceinline__ Jac<F> jac_add(const Jac<F>& P, const Jac<F>& Q) {
  if (f_is_zero(Q.z)) return P;
  if (f_is_zero(P.z)) return Q;
  const F Z1Z1 = f_mul(P.z, P.z);
  const F U2 = f_mul(Q.x, Z1Z1);
  const F S2 = f_mul(Q.y, f_mul(P.z, Z1Z1));
  F U1, S1, Z1Z2;
  if (f_is_one(Q.z)) {
    U1 = P.x;
    S1 = P.y;
    Z1Z2 = P.z;
  } else {
    const F Z2Z2 = f_mul(Q.z, Q.z);
    U1 = f_mul(P.x, Z2Z2);
    S1 = f_mul(P.y, f_mul(Q.z, Z2Z2));
    Z1Z2 = f_mul(P.z, Q.z);
  }
  const F H = f_sub(U2, U1);
  const F r = f_sub(S2, S1);
  if (COMPLETE && f_is_zero(H) && f_is_zero(r)) return jac_double(P);
  const F HH = f_mul(H, H);
  const F rr = f_mul(r, r);
  const F HHH = f_mul(H, HH);
  const F V = f_mul(U1, HH);
  Jac<F> R;
  R.z = f_mul(Z1Z2, H);
  R.x = f_sub(f_sub(rr, HHH), f_add(V, V));
  R.y = f_sub(f_mul(r, f_sub(V, R.x)), f_mul(S1, HHH));
  return R;
}

// ---- the tensor boundary: 16 x 16-bit limbs per Fp, limb-major int32
// arrays (read as uint32). Limb k of lane i sits at ptr[k * ld + i]; a G2
// coordinate is two component arrays c0, c1 with the same row stride.

struct InArrs {
  const uint32_t* p[6];   // G1: x, y, z; G2: x0, x1, y0, y1, z0, z1
  long long ld;           // row stride in words
};

struct OutArrs {
  uint32_t* p[6];
  long long ld;
};

template <class E = Fp>
__device__ __forceinline__ E load_fp(const uint32_t* a, size_t idx, size_t ld) {
  E r;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    r.w[k] = a[idx + (size_t)(2 * k) * ld] | (a[idx + (size_t)(2 * k + 1) * ld] << 16);
  return r;
}

template <class E>
__device__ __forceinline__ void store_fp(uint32_t* a, size_t idx, size_t ld, const E& v) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[idx + (size_t)(2 * k) * ld] = v.w[k] & 0xFFFFu;
    a[idx + (size_t)(2 * k + 1) * ld] = v.w[k] >> 16;
  }
}

__device__ __forceinline__ void load_coord(Fp& f, const InArrs& a, int c, size_t idx) {
  f = load_fp(a.p[c], idx, (size_t)a.ld);
}
__device__ __forceinline__ void load_coord(Fp2h& f, const InArrs& a, int c, size_t idx) {
  f.v = load_fp(pair_odd() ? a.p[2 * c + 1] : a.p[2 * c], idx, (size_t)a.ld);
}
__device__ __forceinline__ void store_coord(const OutArrs& a, int c, size_t idx, const Fp& f) {
  store_fp(a.p[c], idx, (size_t)a.ld, f);
}
__device__ __forceinline__ void store_coord(const OutArrs& a, int c, size_t idx, const Fp2h& f) {
  store_fp(pair_odd() ? a.p[2 * c + 1] : a.p[2 * c], idx, (size_t)a.ld, f.v);
}

template <class F>
__device__ __forceinline__ Jac<F> load_point(const InArrs& a, size_t idx) {
  Jac<F> P;
  load_coord(P.x, a, 0, idx);
  load_coord(P.y, a, 1, idx);
  load_coord(P.z, a, 2, idx);
  return P;
}

template <class F>
__device__ __forceinline__ void store_point(const OutArrs& a, size_t idx, const Jac<F>& P) {
  store_coord(a, 0, idx, P.x);
  store_coord(a, 1, idx, P.y);
  store_coord(a, 2, idx, P.z);
}

}  // namespace zksc

// Mersenne-31 arithmetic for the STARK kernels (csrc/stark_kernels.cu).
//
// Values are canonical uint32 in [0, p), p = 2^31 - 1, as the port's int64
// plain versions (stark/m31.py) and the JAX package's uint32 arrays hold
// them. A product is formed in 64 bits (one IMAD.WIDE) and reduced by
// folding: 2^31 = 1 (mod p), so x = hi * 2^31 + lo = hi + lo.
#pragma once

#include <cstdint>

namespace zksc {

constexpr uint32_t kP31 = 0x7FFFFFFFu;
constexpr uint32_t kInv2 = 0x40000000u;   // 2^-1 mod p = (p + 1) / 2

// any uint64 -> [0, p): a fold leaves x < 2^34, a second (in 32 bits) at
// most p + 7, then one subtract
__device__ __forceinline__ uint32_t m31_red(uint64_t x) {
  x = (x & kP31) + (x >> 31);
  const uint32_t y = ((uint32_t)x & kP31) + (uint32_t)(x >> 31);
  return y >= kP31 ? y - kP31 : y;
}

__device__ __forceinline__ uint32_t m31_add(uint32_t a, uint32_t b) {
  const uint32_t r = a + b;                 // < 2^32: a, b < 2^31
  return r >= kP31 ? r - kP31 : r;
}

__device__ __forceinline__ uint32_t m31_sub(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + (kP31 - b);
}

__device__ __forceinline__ uint32_t m31_mul(uint32_t a, uint32_t b) {
  return m31_red((uint64_t)a * b);
}

__device__ __forceinline__ uint32_t umin32(uint32_t a, uint32_t b) { return a < b ? a : b; }

// a * b mod p where a * b < 2^62 - 1 (canonical a, b, or b (2^31 - b)):
// lo + hi (2^31 = 1) is then below 2p and one subtraction is left, taken
// as the smaller of s and s - p (which wraps when s < p). Five issue slots
// on sm_90a against m31_mul's ten.
__device__ __forceinline__ uint32_t m31_mulc(uint32_t a, uint32_t b) {
  const uint64_t t = (uint64_t)a * b;
  const uint32_t s = ((uint32_t)t & kP31) + (uint32_t)(t >> 31);
  return umin32(s, s - kP31);
}

}  // namespace zksc

// Native witness-tape executor.
//
// Fills the role of the reference's native witness generation (gnark builds
// assignments in compiled Go, provers.go:152-174; circom ships a compiled
// WASM witness calculator — SURVEY.md §2.5 item 3). The Python circuit
// definition is compiled ONCE into a flat instruction tape (r1cs/tape.py);
// this executor evaluates the tape over a batch of witness columns in plain
// uint64 arithmetic. The tape builder proves (by static range analysis) that
// every intermediate stays below 2^62 and every subtraction is non-negative,
// so no modular reduction is needed — cipher circuits are bit-level and the
// widest value is a 60-bit S-box spread product.
//
// Build: g++ -O3 -shared -fPIC -o libzksc_tape.so tape_exec.cc
#include <cstdint>

namespace {

enum Op : uint8_t {
  OP_CONST = 1,   // regs[dst] = k
  OP_ADD = 2,     // regs[dst] = regs[a] + regs[b]
  OP_SUB = 3,     // regs[dst] = regs[a] - regs[b]   (proven non-negative)
  OP_MULK = 4,    // regs[dst] = regs[a] * k
  OP_MUL = 5,     // regs[dst] = regs[a] * regs[b]
  OP_XOR = 6,     // regs[dst] = a + b - 2ab         (boolean operands)
  OP_BIT = 7,     // regs[dst] = (regs[a] >> k) & 1
};

}  // namespace

extern "C" {

// Execute ops[start, end) over a register file regs[n_regs][batch]
// (row-major). Returns 0 on success, the 1-based op index on an unknown
// opcode. Input registers must be prefilled by the caller; hint outputs are
// written between segment calls (the tape splits at hint boundaries).
int zksc_run_tape(const uint8_t* ops, const int32_t* ra, const int32_t* rb,
                  const int32_t* rd, const int64_t* kk, int64_t start,
                  int64_t end, uint64_t* regs, int64_t n_regs,
                  int64_t batch) {
  (void)n_regs;
  for (int64_t i = start; i < end; ++i) {
    const uint64_t* pa = regs + (int64_t)ra[i] * batch;
    const uint64_t* pb = regs + (int64_t)rb[i] * batch;
    uint64_t* pd = regs + (int64_t)rd[i] * batch;
    const int64_t k = kk[i];
    switch (ops[i]) {
      case OP_CONST: {
        const uint64_t kv = (uint64_t)k;
        for (int64_t j = 0; j < batch; ++j) pd[j] = kv;
        break;
      }
      case OP_ADD:
        for (int64_t j = 0; j < batch; ++j) pd[j] = pa[j] + pb[j];
        break;
      case OP_SUB:
        for (int64_t j = 0; j < batch; ++j) pd[j] = pa[j] - pb[j];
        break;
      case OP_MULK: {
        const uint64_t kv = (uint64_t)k;
        for (int64_t j = 0; j < batch; ++j) pd[j] = pa[j] * kv;
        break;
      }
      case OP_MUL:
        for (int64_t j = 0; j < batch; ++j) pd[j] = pa[j] * pb[j];
        break;
      case OP_XOR:
        for (int64_t j = 0; j < batch; ++j)
          pd[j] = pa[j] + pb[j] - 2 * pa[j] * pb[j];
        break;
      case OP_BIT: {
        const int sh = (int)k;
        for (int64_t j = 0; j < batch; ++j) pd[j] = (pa[j] >> sh) & 1u;
        break;
      }
      default:
        return (int)(i + 1);
    }
  }
  return 0;
}

}  // extern "C"

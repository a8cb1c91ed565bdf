// Minimal WebAssembly interpreter for circom witness-generator modules.
//
// The reference's snarkjs operator runs witness generation inside
// circom-compiled WASM (js/src/snarkjs/operator.ts:54-106, circom_runtime
// calculator protocol). This is the port's native equivalent: a small
// integer-only WASM MVP interpreter (the circom 2.x wasm backend emits no
// floats, no SIMD) with the four `runtime.*` host imports the calculator
// expects. Exposed to Python via ctypes (see interop/circom_wasm.py).
//
// Supported: i32/i64 full integer op set, the f64 subset rustc emits for
// wasm-bindgen glue, loads/stores, block/loop/if/else (incl. type-index
// blocktypes with params/results), br/br_if/br_table, call/call_indirect,
// multi-value function returns, select, locals, globals, memory size/grow,
// active data segments, funcref tables + elem segments, and the
// wasm-bindgen host imports (__wbindgen_throw, __wbindgen_init_externref_
// table) — enough to run both circom calculators and the reference's
// wasm-bindgen stwo module. Traps (OOB access, unreachable, div-by-zero,
// runtime.exceptionHandler) abort the call and surface a nonzero code.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

typedef uint64_t Val;

struct FuncType {
  std::vector<uint8_t> params, results;
};

struct Block {
  uint32_t else_pc = 0;  // for `if`
  uint32_t end_pc = 0;
};

struct Func {
  uint32_t type = 0;
  uint32_t nlocals = 0;        // beyond params
  const uint8_t* code = nullptr;
  uint32_t len = 0;
  std::unordered_map<uint32_t, Block> blocks;  // pc of block/loop/if opcode
};

struct Export {
  uint8_t kind;
  uint32_t idx;
};

struct Module {
  std::vector<uint8_t> bytes;
  std::vector<FuncType> types;
  std::vector<Func> funcs;     // imports first (code == nullptr)
  uint32_t n_imports = 0;
  std::vector<std::string> import_names;
  std::vector<Val> globals;
  std::vector<uint32_t> table;
  std::unordered_map<std::string, Export> exports;
  std::vector<uint8_t> mem;
  uint32_t mem_pages = 0, mem_max = 16384;  // 1 GiB cap
  // runtime state
  int trap = 0;                // 0 = ok
  uint32_t exception_code = 0; // from runtime.exceptionHandler
  std::string trap_msg;        // from __wbindgen_throw
  // call tracing (wvm_trace_*): function index -> what to record per call
  struct TraceSpec {
    int ptr_arg; int len_arg; uint32_t fixed_len;
    int ptr_arg2 = -1; uint32_t fixed_len2 = 0;   // optional second region
  };
  std::unordered_map<uint32_t, TraceSpec> trace_specs;
  std::vector<uint8_t> trace_log;
};

struct Reader {
  const uint8_t* d;
  size_t n, o = 0;
  bool fail = false;
  uint8_t u8() {
    if (o >= n) { fail = true; return 0; }
    return d[o++];
  }
  uint64_t uleb() {
    uint64_t r = 0; int s = 0;
    while (true) {
      uint8_t b = u8();
      r |= (uint64_t)(b & 0x7f) << s;
      if (!(b & 0x80)) return r;
      s += 7;
      if (s > 63) { fail = true; return r; }
    }
  }
  int64_t sleb() {
    int64_t r = 0; int s = 0; uint8_t b;
    do {
      b = u8();
      r |= (int64_t)(b & 0x7f) << s;
      s += 7;
    } while (b & 0x80 && s < 70);
    if (s < 64 && (b & 0x40)) r |= -((int64_t)1 << s);
    return r;
  }
  void skip(size_t k) { o = (o + k <= n) ? o + k : (fail = true, n); }
};

// Pre-pass: match block/loop/if with else/end so br targets are O(1).
bool index_blocks(Func& f) {
  std::vector<uint32_t> stack;  // pc of opener (function frame = UINT32_MAX)
  stack.push_back(UINT32_MAX);
  Reader r{f.code, f.len};
  while (r.o < r.n && !r.fail) {
    uint32_t pc = (uint32_t)r.o;
    uint8_t op = r.u8();
    switch (op) {
      case 0x02: case 0x03: case 0x04:   // block/loop/if
        r.sleb();                        // blocktype
        stack.push_back(pc);
        f.blocks[pc];                    // create
        break;
      case 0x05: {                       // else
        if (stack.empty()) return false;
        f.blocks[stack.back()].else_pc = pc;
        break;
      }
      case 0x0b: {                       // end
        if (stack.empty()) return false;
        uint32_t open = stack.back();
        stack.pop_back();
        if (open != UINT32_MAX) f.blocks[open].end_pc = pc;
        if (stack.empty()) return r.o == r.n;  // function end
        break;
      }
      case 0x0c: case 0x0d: case 0x10: case 0x20: case 0x21: case 0x22:
      case 0x23: case 0x24: case 0x3f: case 0x40:
        r.uleb(); break;
      case 0x11: r.uleb(); r.uleb(); break;
      case 0x0e: {
        uint64_t k = r.uleb();
        for (uint64_t i = 0; i <= k; i++) r.uleb();
        break;
      }
      case 0x41: r.sleb(); break;
      case 0x42: r.sleb(); break;
      case 0x43: r.skip(4); break;
      case 0x44: r.skip(8); break;
      default:
        if (op >= 0x28 && op <= 0x3e) { r.uleb(); r.uleb(); }
        else if (op == 0xfc) {
          uint64_t sub = r.uleb();
          if (sub == 10) r.skip(2);          // memory.copy
          else if (sub == 11) r.skip(1);     // memory.fill
          else if (sub == 8) { r.uleb(); r.skip(1); }  // memory.init
          else if (sub <= 7) { /* trunc_sat: no imm */ }
          else return false;
        }
        // all other used opcodes have no immediates
        break;
    }
  }
  return !r.fail;
}

struct Label {
  uint32_t target;   // pc to jump to on br
  uint32_t height;   // value-stack height at entry
  uint8_t arity;     // values carried over the br
  bool is_loop;
};

class VM {
 public:
  explicit VM(Module& m) : m_(m) {}

  bool call(uint32_t fidx, const Val* args, Val* ret) {
    if (m_.trap) return false;
    const Func& f = m_.funcs[fidx];
    const FuncType& ft = m_.types[f.type];
    if (!m_.trace_specs.empty()) trace_hook(fidx, args, ft.params.size());
    if (f.code == nullptr) return host_call(fidx, args, ret);
    std::vector<Val> locals(ft.params.size() + f.nlocals, 0);
    for (size_t i = 0; i < ft.params.size(); i++) locals[i] = args[i];
    std::vector<Val> stack;
    stack.reserve(64);
    if (!run(f, locals, stack)) return false;
    size_t nr = ft.results.size();
    for (size_t i = 0; i < nr; i++)
      ret[i] = (i < stack.size())
                   ? stack[stack.size() - nr + i] : 0;
    return true;
  }

 private:
  Module& m_;
  int depth_ = 0;

  // Record one call of a traced function: u32 fi, u32 nargs, u64 args[],
  // u32 dump_len, dump bytes (linear memory at args[ptr_arg]). Used by the
  // interop layer to observe e.g. hash-compression inputs inside the
  // reference modules (reverse-engineering aid; off unless specs are set).
  void trace_hook(uint32_t fidx, const Val* args, size_t nargs) {
    auto it = m_.trace_specs.find(fidx);
    if (it == m_.trace_specs.end()) return;
    if (m_.trace_log.size() > (1u << 30)) return;      // 1 GiB safety cap
    const auto& sp = it->second;
    auto& L = m_.trace_log;
    auto put32 = [&](uint32_t v) {
      for (int i = 0; i < 4; i++) L.push_back((v >> (8 * i)) & 0xFF);
    };
    auto put64 = [&](uint64_t v) {
      for (int i = 0; i < 8; i++) L.push_back((v >> (8 * i)) & 0xFF);
    };
    put32(fidx);
    put32((uint32_t)nargs);
    for (size_t i = 0; i < nargs; i++) put64(args[i]);
    auto dump = [&](int ptr_arg, int len_arg, uint32_t fixed_len) {
      uint64_t dump_len = 0, base = 0;
      if (ptr_arg >= 0 && (size_t)ptr_arg < nargs) {
        base = (uint32_t)args[ptr_arg];
        dump_len = (len_arg >= 0 && (size_t)len_arg < nargs)
                       ? (uint64_t)(uint32_t)args[len_arg] : fixed_len;
        if (base >= m_.mem.size()) dump_len = 0;
        else if (base + dump_len > m_.mem.size())
          dump_len = m_.mem.size() - base;
        if (dump_len > (1u << 24)) dump_len = 1u << 24;
      }
      put32((uint32_t)dump_len);
      for (uint64_t i = 0; i < dump_len; i++) L.push_back(m_.mem[base + i]);
    };
    dump(sp.ptr_arg, sp.len_arg, sp.fixed_len);
    dump(sp.ptr_arg2, -1, sp.fixed_len2);
  }

  bool host_call(uint32_t fidx, const Val* args, Val*) {
    const std::string& name = m_.import_names[fidx];
    if (name == "exceptionHandler") {
      m_.exception_code = (uint32_t)args[0];
      m_.trap = 100 + (int)(uint32_t)args[0];
      return false;
    }
    // wasm-bindgen: __wbg___wbindgen_throw_<hash>(ptr, len) raises a JS
    // Error with a utf-8 message in linear memory
    if (name.find("__wbindgen_throw") != std::string::npos) {
      uint32_t p = (uint32_t)args[0], l = (uint32_t)args[1];
      if ((uint64_t)p + l <= m_.mem.size() && l < 4096)
        m_.trap_msg.assign((const char*)&m_.mem[p], l);
      m_.trap = 99;
      return false;
    }
    // __wbindgen_init_externref_table: the externref table only carries JS
    // values for the glue's own bookkeeping; nothing we execute reads it
    // (no table.get/set opcodes in the module), so init is a no-op.
    // circom: printErrorMessage / writeBufferMessage / showSharedRWMemory
    // are no-ops (messages retrievable via the exported getMessageChar).
    return true;
  }

  bool trap(int code) {
    if (!m_.trap) m_.trap = code;
    return false;
  }

  // blocktype: -64 = void, other negative = one valtype, >=0 = type index
  uint8_t block_arity(int64_t bt) const {
    if (bt == -64) return 0;
    if (bt < 0) return 1;
    return (uint8_t)m_.types[(size_t)bt].results.size();
  }
  uint8_t block_params(int64_t bt) const {
    return bt >= 0 ? (uint8_t)m_.types[(size_t)bt].params.size() : 0;
  }

  bool run(const Func& f, std::vector<Val>& locals, std::vector<Val>& stack) {
    if (++depth_ > 2048) { --depth_; return trap(3); }
    Reader r{f.code, f.len};
    std::vector<Label> labels;
    labels.push_back({f.len, 0, 0, false});  // function frame

#define POP() (stack.back())
#define PUSH(v) stack.push_back((Val)(v))
    while (r.o < r.n) {
      uint32_t pc = (uint32_t)r.o;
      uint8_t op = r.u8();
      switch (op) {
        case 0x00: --depth_; return trap(1);       // unreachable
        case 0x01: break;                          // nop
        case 0x02: {                               // block
          int64_t bt = r.sleb();
          labels.push_back({f.blocks.at(pc).end_pc + 1,
                            (uint32_t)(stack.size() - block_params(bt)),
                            block_arity(bt), false});
          break;
        }
        case 0x03: {                               // loop
          int64_t bt = r.sleb();
          // br to a loop re-enters with the loop's PARAMS on the stack
          labels.push_back({(uint32_t)r.o,
                            (uint32_t)(stack.size() - block_params(bt)),
                            block_params(bt), true});
          break;
        }
        case 0x04: {                               // if
          int64_t bt = r.sleb();
          uint32_t c = (uint32_t)stack.back(); stack.pop_back();
          const Block& b = f.blocks.at(pc);
          labels.push_back({b.end_pc + 1,
                            (uint32_t)(stack.size() - block_params(bt)),
                            block_arity(bt), false});
          if (!c) {
            if (b.else_pc) r.o = b.else_pc + 1;
            else { r.o = b.end_pc + 1; labels.pop_back(); }
          }
          break;
        }
        case 0x05: {                               // else: end of then-branch
          r.o = labels.back().target;              // jump past end
          labels.pop_back();
          break;
        }
        case 0x0b: {                               // end
          labels.pop_back();
          if (labels.empty()) { --depth_; return true; }
          break;
        }
        case 0x0c: case 0x0d: {                    // br / br_if
          uint64_t d = r.uleb();
          if (op == 0x0d) {
            uint32_t c = (uint32_t)stack.back(); stack.pop_back();
            if (!c) break;
          }
          if (!do_br(d, labels, stack, r)) { --depth_; return false; }
          if (labels.empty()) { --depth_; return true; }
          break;
        }
        case 0x0e: {                               // br_table
          uint64_t k = r.uleb();
          std::vector<uint64_t> tgts(k);
          for (uint64_t i = 0; i < k; i++) tgts[i] = r.uleb();
          uint64_t dflt = r.uleb();
          uint32_t v = (uint32_t)stack.back(); stack.pop_back();
          uint64_t d = v < k ? tgts[v] : dflt;
          if (!do_br(d, labels, stack, r)) { --depth_; return false; }
          if (labels.empty()) { --depth_; return true; }
          break;
        }
        case 0x0f: --depth_; return true;          // return (result on stack)
        case 0x10: {                               // call
          uint32_t fi = (uint32_t)r.uleb();
          if (!invoke(fi, stack)) { --depth_; return false; }
          break;
        }
        case 0x11: {                               // call_indirect
          uint32_t ti = (uint32_t)r.uleb();
          r.uleb();                                // table index (0)
          uint32_t elem = (uint32_t)stack.back(); stack.pop_back();
          if (elem >= m_.table.size()) { --depth_; return trap(4); }
          uint32_t fi = m_.table[elem];
          if (fi == UINT32_MAX || m_.funcs[fi].type != ti) {
            --depth_; return trap(5);
          }
          if (!invoke(fi, stack)) { --depth_; return false; }
          break;
        }
        case 0x1a: stack.pop_back(); break;        // drop
        case 0x1b: {                               // select
          uint32_t c = (uint32_t)stack.back(); stack.pop_back();
          Val b = stack.back(); stack.pop_back();
          Val a = stack.back(); stack.pop_back();
          PUSH(c ? a : b);
          break;
        }
        case 0x20: PUSH(locals[r.uleb()]); break;
        case 0x21: locals[r.uleb()] = stack.back(); stack.pop_back(); break;
        case 0x22: locals[r.uleb()] = stack.back(); break;
        case 0x23: PUSH(m_.globals[r.uleb()]); break;
        case 0x24: m_.globals[r.uleb()] = stack.back(); stack.pop_back();
                   break;
        case 0x3f: r.uleb(); PUSH((uint32_t)m_.mem_pages); break;
        case 0x40: {                               // memory.grow
          r.uleb();
          uint32_t delta = (uint32_t)stack.back(); stack.pop_back();
          uint64_t np = (uint64_t)m_.mem_pages + delta;
          if (np > m_.mem_max) { PUSH((uint32_t)-1); break; }
          PUSH((uint32_t)m_.mem_pages);
          m_.mem_pages = (uint32_t)np;
          m_.mem.resize((size_t)np << 16, 0);
          break;
        }
        case 0x41: PUSH((uint32_t)(int32_t)r.sleb()); break;  // i32.const
        case 0x42: PUSH((uint64_t)r.sleb()); break;           // i64.const
        case 0x43: {                                          // f32.const
          uint32_t v = 0;
          for (int i = 0; i < 4; i++) v |= (uint32_t)r.u8() << (8 * i);
          PUSH(v); break;
        }
        case 0x44: {                                          // f64.const
          uint64_t v = 0;
          for (int i = 0; i < 8; i++) v |= (uint64_t)r.u8() << (8 * i);
          PUSH(v); break;
        }
        default:
          if (op >= 0x28 && op <= 0x3e) {
            if (!memop(op, r, stack)) { --depth_; return false; }
          } else if (op >= 0x45 && op <= 0xc4) {
            if (!numop(op, stack)) { --depth_; return false; }
          } else if (op == 0xfc) {
            uint64_t sub = r.uleb();
            if (sub == 10) {                       // memory.copy
              r.skip(2);
              uint32_t n = (uint32_t)stack.back(); stack.pop_back();
              uint32_t s = (uint32_t)stack.back(); stack.pop_back();
              uint32_t d = (uint32_t)stack.back(); stack.pop_back();
              if ((uint64_t)d + n > m_.mem.size() ||
                  (uint64_t)s + n > m_.mem.size()) { --depth_; return trap(2); }
              memmove(&m_.mem[d], &m_.mem[s], n);
            } else if (sub == 11) {                // memory.fill
              r.skip(1);
              uint32_t n = (uint32_t)stack.back(); stack.pop_back();
              uint32_t v = (uint32_t)stack.back(); stack.pop_back();
              uint32_t d = (uint32_t)stack.back(); stack.pop_back();
              if ((uint64_t)d + n > m_.mem.size()) { --depth_; return trap(2); }
              memset(&m_.mem[d], (int)(uint8_t)v, n);
            } else if (sub == 2 || sub == 3) {     // i32.trunc_sat_f64_s/u
              double a; { Val v = stack.back(); stack.pop_back();
                          memcpy(&a, &v, 8); }
              if (sub == 2) {
                int32_t r2 = a != a ? 0 : a <= -2147483648.0 ? INT32_MIN :
                             a >= 2147483647.0 ? INT32_MAX : (int32_t)a;
                stack.push_back((uint32_t)r2);
              } else {
                uint32_t r2 = (a != a || a <= 0.0) ? 0 :
                              a >= 4294967295.0 ? UINT32_MAX : (uint32_t)a;
                stack.push_back(r2);
              }
            } else { --depth_; return trap(6); }
          } else { --depth_; return trap(6); }     // unsupported opcode
      }
      if (r.fail) { --depth_; return trap(7); }
    }
    --depth_;
    return true;
  }

  bool invoke(uint32_t fi, std::vector<Val>& stack) {
    const FuncType& ft = m_.types[m_.funcs[fi].type];
    size_t np = ft.params.size(), nr = ft.results.size();
    Val args[128], rets[8] = {0};
    if (np > 128 || nr > 8) return trap(8);
    for (size_t i = 0; i < np; i++) args[i] = stack[stack.size() - np + i];
    stack.resize(stack.size() - np);
    if (!call(fi, args, rets)) return false;
    for (size_t i = 0; i < nr; i++) stack.push_back(rets[i]);
    return true;
  }

  bool do_br(uint64_t d, std::vector<Label>& labels, std::vector<Val>& stack,
             Reader& r) {
    if (d >= labels.size()) return trap(9);
    size_t li = labels.size() - 1 - d;
    if (li == 0) { labels.clear(); return true; }  // br to function frame
    Label L = labels[li];
    uint8_t arity = L.arity;                       // loop: params, else results
    Val kept[8];
    if (arity > 8 || arity > stack.size()) return trap(9);
    for (uint8_t i = 0; i < arity; i++)
      kept[i] = stack[stack.size() - arity + i];
    stack.resize(L.height);
    for (uint8_t i = 0; i < arity; i++) stack.push_back(kept[i]);
    r.o = L.target;
    labels.resize(L.is_loop ? li + 1 : li);
    return true;
  }

  bool memop(uint8_t op, Reader& r, std::vector<Val>& stack) {
    r.uleb();                                      // align
    uint64_t off = r.uleb();
    auto& mem = m_.mem;
    // memarg offsets are u32 in wasm32; a larger encoded value could make
    // (u32)addr + off wrap u64 and bypass the bounds check below.
    if (off > UINT32_MAX) off = UINT64_MAX >> 8;   // forces the trap path
    auto addr = [&](size_t width, bool store, Val* sv) -> uint64_t {
      Val v = 0;
      if (store) { v = stack.back(); stack.pop_back(); }
      uint64_t a = (uint32_t)stack.back() + off; stack.pop_back();
      if (a + width > mem.size()) return UINT64_MAX;
      if (store) *sv = v;
      return a;
    };
    Val sv; uint64_t a;
    switch (op) {
      case 0x28: if ((a = addr(4, false, 0)) == UINT64_MAX) return trap(2);
        { uint32_t v; memcpy(&v, &mem[a], 4); stack.push_back(v); } break;
      case 0x29: case 0x2b:                        // i64.load / f64.load
        if ((a = addr(8, false, 0)) == UINT64_MAX) return trap(2);
        { uint64_t v; memcpy(&v, &mem[a], 8); stack.push_back(v); } break;
      case 0x2a: if ((a = addr(4, false, 0)) == UINT64_MAX) return trap(2);
        { uint32_t v; memcpy(&v, &mem[a], 4); stack.push_back(v); } break;
      case 0x2c: if ((a = addr(1, false, 0)) == UINT64_MAX) return trap(2);
        stack.push_back((uint32_t)(int32_t)(int8_t)mem[a]); break;
      case 0x2d: if ((a = addr(1, false, 0)) == UINT64_MAX) return trap(2);
        stack.push_back(mem[a]); break;
      case 0x2e: if ((a = addr(2, false, 0)) == UINT64_MAX) return trap(2);
        { int16_t v; memcpy(&v, &mem[a], 2);
          stack.push_back((uint32_t)(int32_t)v); } break;
      case 0x2f: if ((a = addr(2, false, 0)) == UINT64_MAX) return trap(2);
        { uint16_t v; memcpy(&v, &mem[a], 2); stack.push_back(v); } break;
      case 0x30: if ((a = addr(1, false, 0)) == UINT64_MAX) return trap(2);
        stack.push_back((uint64_t)(int64_t)(int8_t)mem[a]); break;
      case 0x31: if ((a = addr(1, false, 0)) == UINT64_MAX) return trap(2);
        stack.push_back(mem[a]); break;
      case 0x32: if ((a = addr(2, false, 0)) == UINT64_MAX) return trap(2);
        { int16_t v; memcpy(&v, &mem[a], 2);
          stack.push_back((uint64_t)(int64_t)v); } break;
      case 0x33: if ((a = addr(2, false, 0)) == UINT64_MAX) return trap(2);
        { uint16_t v; memcpy(&v, &mem[a], 2); stack.push_back(v); } break;
      case 0x34: if ((a = addr(4, false, 0)) == UINT64_MAX) return trap(2);
        { int32_t v; memcpy(&v, &mem[a], 4);
          stack.push_back((uint64_t)(int64_t)v); } break;
      case 0x35: if ((a = addr(4, false, 0)) == UINT64_MAX) return trap(2);
        { uint32_t v; memcpy(&v, &mem[a], 4);
          stack.push_back((uint64_t)v); } break;
      case 0x36: if ((a = addr(4, true, &sv)) == UINT64_MAX) return trap(2);
        { uint32_t v = (uint32_t)sv; memcpy(&mem[a], &v, 4); } break;
      case 0x37: case 0x39:                        // i64.store / f64.store
        if ((a = addr(8, true, &sv)) == UINT64_MAX) return trap(2);
        memcpy(&mem[a], &sv, 8); break;
      case 0x38: if ((a = addr(4, true, &sv)) == UINT64_MAX) return trap(2);
        { uint32_t v = (uint32_t)sv; memcpy(&mem[a], &v, 4); } break;
      case 0x3a: if ((a = addr(1, true, &sv)) == UINT64_MAX) return trap(2);
        mem[a] = (uint8_t)sv; break;
      case 0x3b: if ((a = addr(2, true, &sv)) == UINT64_MAX) return trap(2);
        { uint16_t v = (uint16_t)sv; memcpy(&mem[a], &v, 2); } break;
      case 0x3c: if ((a = addr(1, true, &sv)) == UINT64_MAX) return trap(2);
        mem[a] = (uint8_t)sv; break;
      case 0x3d: if ((a = addr(2, true, &sv)) == UINT64_MAX) return trap(2);
        { uint16_t v = (uint16_t)sv; memcpy(&mem[a], &v, 2); } break;
      case 0x3e: if ((a = addr(4, true, &sv)) == UINT64_MAX) return trap(2);
        { uint32_t v = (uint32_t)sv; memcpy(&mem[a], &v, 4); } break;
      default: return trap(6);
    }
    return true;
  }

  bool numop(uint8_t op, std::vector<Val>& stack) {
    auto pop = [&]() { Val v = stack.back(); stack.pop_back(); return v; };
#define BIN32(expr) { uint32_t b = (uint32_t)pop(), a = (uint32_t)pop(); \
    stack.push_back((uint32_t)(expr)); } break
#define BIN32S(expr) { int32_t b = (int32_t)(uint32_t)pop(), \
    a = (int32_t)(uint32_t)pop(); stack.push_back((uint32_t)(expr)); } break
#define BIN64(expr) { uint64_t b = pop(), a = pop(); \
    stack.push_back((uint64_t)(expr)); } break
#define BIN64S(expr) { int64_t b = (int64_t)pop(), a = (int64_t)pop(); \
    stack.push_back((uint64_t)(expr)); } break
    switch (op) {
      case 0x45: stack.back() = (uint32_t)stack.back() == 0; break;
      case 0x46: BIN32(a == b);
      case 0x47: BIN32(a != b);
      case 0x48: BIN32S(a < b);
      case 0x49: BIN32(a < b);
      case 0x4a: BIN32S(a > b);
      case 0x4b: BIN32(a > b);
      case 0x4c: BIN32S(a <= b);
      case 0x4d: BIN32(a <= b);
      case 0x4e: BIN32S(a >= b);
      case 0x4f: BIN32(a >= b);
      case 0x50: stack.back() = stack.back() == 0; break;
      case 0x51: BIN64(a == b);
      case 0x52: BIN64(a != b);
      case 0x53: BIN64S(a < b);
      case 0x54: BIN64(a < b);
      case 0x55: BIN64S(a > b);
      case 0x56: BIN64(a > b);
      case 0x57: BIN64S(a <= b);
      case 0x58: BIN64(a <= b);
      case 0x59: BIN64S(a >= b);
      case 0x5a: BIN64(a >= b);
      case 0x67: { uint32_t a = (uint32_t)pop();
        stack.push_back((uint32_t)(a ? __builtin_clz(a) : 32)); } break;
      case 0x68: { uint32_t a = (uint32_t)pop();
        stack.push_back((uint32_t)(a ? __builtin_ctz(a) : 32)); } break;
      case 0x69: { uint32_t a = (uint32_t)pop();
        stack.push_back((uint32_t)__builtin_popcount(a)); } break;
      case 0x6a: BIN32(a + b);
      case 0x6b: BIN32(a - b);
      case 0x6c: BIN32(a * b);
      case 0x6d: { int32_t b = (int32_t)(uint32_t)pop(),
                   a = (int32_t)(uint32_t)pop();
        if (!b || (a == INT32_MIN && b == -1)) return trap(10);
        stack.push_back((uint32_t)(a / b)); } break;
      case 0x6e: { uint32_t b = (uint32_t)pop(), a = (uint32_t)pop();
        if (!b) return trap(10);
        stack.push_back(a / b); } break;
      case 0x6f: { int32_t b = (int32_t)(uint32_t)pop(),
                   a = (int32_t)(uint32_t)pop();
        if (!b) return trap(10);
        stack.push_back((uint32_t)(b == -1 ? 0 : a % b)); } break;
      case 0x70: { uint32_t b = (uint32_t)pop(), a = (uint32_t)pop();
        if (!b) return trap(10);
        stack.push_back(a % b); } break;
      case 0x71: BIN32(a & b);
      case 0x72: BIN32(a | b);
      case 0x73: BIN32(a ^ b);
      case 0x74: BIN32(a << (b & 31));
      case 0x75: BIN32S(a >> ((uint32_t)b & 31));
      case 0x76: BIN32(a >> (b & 31));
      case 0x77: BIN32((a << (b & 31)) | (a >> ((32 - b) & 31)));
      case 0x78: BIN32((a >> (b & 31)) | (a << ((32 - b) & 31)));
      case 0x79: { uint64_t a = pop();
        stack.push_back((uint64_t)(a ? __builtin_clzll(a) : 64)); } break;
      case 0x7a: { uint64_t a = pop();
        stack.push_back((uint64_t)(a ? __builtin_ctzll(a) : 64)); } break;
      case 0x7b: { uint64_t a = pop();
        stack.push_back((uint64_t)__builtin_popcountll(a)); } break;
      case 0x7c: BIN64(a + b);
      case 0x7d: BIN64(a - b);
      case 0x7e: BIN64(a * b);
      case 0x7f: { int64_t b = (int64_t)pop(), a = (int64_t)pop();
        if (!b || (a == INT64_MIN && b == -1)) return trap(10);
        stack.push_back((uint64_t)(a / b)); } break;
      case 0x80: { uint64_t b = pop(), a = pop();
        if (!b) return trap(10);
        stack.push_back(a / b); } break;
      case 0x81: { int64_t b = (int64_t)pop(), a = (int64_t)pop();
        if (!b) return trap(10);
        stack.push_back((uint64_t)(b == -1 ? 0 : a % b)); } break;
      case 0x82: { uint64_t b = pop(), a = pop();
        if (!b) return trap(10);
        stack.push_back(a % b); } break;
      case 0x83: BIN64(a & b);
      case 0x84: BIN64(a | b);
      case 0x85: BIN64(a ^ b);
      case 0x86: BIN64(a << (b & 63));
      case 0x87: BIN64S(a >> ((uint64_t)b & 63));
      case 0x88: BIN64(a >> (b & 63));
      case 0x89: BIN64((a << (b & 63)) | (a >> ((64 - b) & 63)));
      case 0x8a: BIN64((a >> (b & 63)) | (a << ((64 - b) & 63)));
      // f64 subset (bit patterns live in the uint64 Vals)
      case 0x61: case 0x62: case 0x63: case 0x64: case 0x65: case 0x66: {
        double b, a;
        { uint64_t vb = pop(), va = pop();
          memcpy(&b, &vb, 8); memcpy(&a, &va, 8); }
        bool r2 = op == 0x61 ? a == b : op == 0x62 ? a != b :
                  op == 0x63 ? a < b : op == 0x64 ? a > b :
                  op == 0x65 ? a <= b : a >= b;
        stack.push_back((uint32_t)r2); break;
      }
      case 0x99: case 0x9a: case 0x9b: case 0x9c: case 0x9d: case 0x9e:
      case 0x9f: {
        double a; { uint64_t v = pop(); memcpy(&a, &v, 8); }
        double r2 = op == 0x99 ? std::fabs(a) : op == 0x9a ? -a :
                    op == 0x9b ? std::ceil(a) : op == 0x9c ? std::floor(a) :
                    op == 0x9d ? std::trunc(a) : op == 0x9e ?
                    std::nearbyint(a) : std::sqrt(a);
        uint64_t v; memcpy(&v, &r2, 8); stack.push_back(v); break;
      }
      case 0xa0: case 0xa1: case 0xa2: case 0xa3: case 0xa4: case 0xa5: {
        double b, a;
        { uint64_t vb = pop(), va = pop();
          memcpy(&b, &vb, 8); memcpy(&a, &va, 8); }
        double r2 = op == 0xa0 ? a + b : op == 0xa1 ? a - b :
                    op == 0xa2 ? a * b : op == 0xa3 ? a / b :
                    op == 0xa4 ? std::fmin(a, b) : std::fmax(a, b);
        uint64_t v; memcpy(&v, &r2, 8); stack.push_back(v); break;
      }
      case 0xb7: {                                 // f64.convert_i32_s
        double r2 = (double)(int32_t)(uint32_t)pop();
        uint64_t v; memcpy(&v, &r2, 8); stack.push_back(v); break;
      }
      case 0xb8: {                                 // f64.convert_i32_u
        double r2 = (double)(uint32_t)pop();
        uint64_t v; memcpy(&v, &r2, 8); stack.push_back(v); break;
      }
      case 0xb9: {                                 // f64.convert_i64_s
        double r2 = (double)(int64_t)pop();
        uint64_t v; memcpy(&v, &r2, 8); stack.push_back(v); break;
      }
      case 0xba: {                                 // f64.convert_i64_u
        double r2 = (double)pop();
        uint64_t v; memcpy(&v, &r2, 8); stack.push_back(v); break;
      }
      case 0xbd: case 0xbf: break;                 // reinterpret: identity
      case 0xa7: stack.back() = (uint32_t)stack.back(); break;  // wrap
      case 0xac: stack.back() =                                // extend_s
        (uint64_t)(int64_t)(int32_t)(uint32_t)stack.back(); break;
      case 0xad: stack.back() = (uint32_t)stack.back(); break;  // extend_u
      case 0xc0: stack.back() =
        (uint32_t)(int32_t)(int8_t)(uint8_t)stack.back(); break;
      case 0xc1: stack.back() =
        (uint32_t)(int32_t)(int16_t)(uint16_t)stack.back(); break;
      case 0xc2: stack.back() =
        (uint64_t)(int64_t)(int8_t)(uint8_t)stack.back(); break;
      case 0xc3: stack.back() =
        (uint64_t)(int64_t)(int16_t)(uint16_t)stack.back(); break;
      case 0xc4: stack.back() =
        (uint64_t)(int64_t)(int32_t)(uint32_t)stack.back(); break;
      default: return trap(6);
    }
    return true;
#undef BIN32
#undef BIN32S
#undef BIN64
#undef BIN64S
  }
};

Module* parse(const uint8_t* bytes, size_t n) {
  if (n < 8 || memcmp(bytes, "\0asm\x01\0\0\0", 8)) return nullptr;
  auto* m = new Module();
  m->bytes.assign(bytes, bytes + n);
  Reader r{m->bytes.data(), n, 8};
  std::vector<uint32_t> func_types;
  const uint8_t* code_sec = nullptr; size_t code_len = 0;
  while (r.o < r.n && !r.fail) {
    uint8_t sid = r.u8();
    uint64_t sz = r.uleb();
    size_t end = r.o + sz;
    if (end > r.n) { delete m; return nullptr; }
    Reader s{m->bytes.data() + r.o, sz};
    switch (sid) {
      case 1: {  // types
        uint64_t cnt = s.uleb();
        for (uint64_t i = 0; i < cnt; i++) {
          if (s.u8() != 0x60) { delete m; return nullptr; }
          FuncType ft;
          uint64_t np = s.uleb();
          for (uint64_t j = 0; j < np; j++) ft.params.push_back(s.u8());
          uint64_t nr = s.uleb();
          for (uint64_t j = 0; j < nr; j++) ft.results.push_back(s.u8());
          m->types.push_back(ft);
        }
        break;
      }
      case 2: {  // imports
        uint64_t cnt = s.uleb();
        for (uint64_t i = 0; i < cnt; i++) {
          uint64_t ml = s.uleb(); s.skip(ml);
          uint64_t nl = s.uleb();
          if (nl > s.n - s.o || s.fail) { delete m; return nullptr; }
          std::string name((const char*)s.d + s.o, nl); s.skip(nl);
          uint8_t kind = s.u8();
          if (kind == 0) {
            Func f; f.type = (uint32_t)s.uleb();
            m->funcs.push_back(f);
            m->import_names.push_back(name);
          } else if (kind == 2) {
            uint8_t flags = s.u8();
            m->mem_pages = (uint32_t)s.uleb();
            if (flags & 1) m->mem_max = (uint32_t)s.uleb();
          } else { delete m; return nullptr; }
        }
        m->n_imports = (uint32_t)m->funcs.size();
        break;
      }
      case 3: {  // function type indices
        uint64_t cnt = s.uleb();
        for (uint64_t i = 0; i < cnt; i++)
          func_types.push_back((uint32_t)s.uleb());
        break;
      }
      case 5: {  // memory
        uint64_t cnt = s.uleb();
        if (cnt) {
          uint8_t flags = s.u8();
          m->mem_pages = (uint32_t)s.uleb();
          if (flags & 1) m->mem_max = (uint32_t)s.uleb();
        }
        break;
      }
      case 6: {  // globals
        uint64_t cnt = s.uleb();
        for (uint64_t i = 0; i < cnt; i++) {
          s.u8(); s.u8();  // valtype, mutability
          uint8_t op = s.u8();
          int64_t v = s.sleb();
          if (s.u8() != 0x0b || (op != 0x41 && op != 0x42)) {
            delete m; return nullptr;
          }
          m->globals.push_back((uint64_t)v);
        }
        break;
      }
      case 7: {  // exports
        uint64_t cnt = s.uleb();
        for (uint64_t i = 0; i < cnt; i++) {
          uint64_t nl = s.uleb();
          if (nl > s.n - s.o || s.fail) { delete m; return nullptr; }
          std::string name((const char*)s.d + s.o, nl); s.skip(nl);
          uint8_t kind = s.u8();
          uint32_t idx = (uint32_t)s.uleb();
          m->exports[name] = {kind, idx};
        }
        break;
      }
      case 9: {  // elem segments (active, table 0)
        uint64_t cnt = s.uleb();
        for (uint64_t i = 0; i < cnt; i++) {
          uint64_t flags = s.uleb();
          if (flags != 0) { delete m; return nullptr; }
          if (s.u8() != 0x41) { delete m; return nullptr; }
          uint32_t base = (uint32_t)(int32_t)s.sleb();
          s.u8();  // end
          uint64_t k = s.uleb();
          if (k > s.n - s.o || s.fail) { delete m; return nullptr; }
          if (m->table.size() < base + k)
            m->table.resize(base + k, UINT32_MAX);
          for (uint64_t j = 0; j < k; j++)
            m->table[base + j] = (uint32_t)s.uleb();
        }
        break;
      }
      case 10:  // code (bodies parsed after all sections)
        code_sec = m->bytes.data() + r.o; code_len = sz;
        break;
      case 11: {  // data segments
        uint64_t cnt = s.uleb();
        for (uint64_t i = 0; i < cnt; i++) {
          uint64_t flags = s.uleb();
          if (flags != 0) { delete m; return nullptr; }
          if (s.u8() != 0x41) { delete m; return nullptr; }
          uint32_t base = (uint32_t)(int32_t)s.sleb();
          s.u8();  // end
          uint64_t k = s.uleb();
          if (k > s.n - s.o || s.fail ||
              (uint64_t)base + k > ((uint64_t)m->mem_pages << 16)) {
            delete m; return nullptr;
          }
          if (m->mem.size() < ((size_t)m->mem_pages << 16))
            m->mem.resize((size_t)m->mem_pages << 16, 0);
          memcpy(&m->mem[base], s.d + s.o, k);
          s.skip(k);
        }
        break;
      }
      default: break;  // table(4), start(8), custom(0): skip
    }
    if (s.fail) { delete m; return nullptr; }
    r.o = end;
  }
  if (m->mem.size() < ((size_t)m->mem_pages << 16))
    m->mem.resize((size_t)m->mem_pages << 16, 0);
  if (code_sec) {
    Reader c{code_sec, code_len};
    uint64_t cnt = c.uleb();
    if (cnt != func_types.size()) { delete m; return nullptr; }
    for (uint64_t i = 0; i < cnt; i++) {
      uint64_t bsz = c.uleb();
      size_t bend = c.o + bsz;
      Func f; f.type = func_types[i];
      uint64_t nl = c.uleb();
      for (uint64_t j = 0; j < nl; j++) {
        uint64_t k = c.uleb(); c.u8();
        f.nlocals += (uint32_t)k;
      }
      f.code = c.d + c.o;
      f.len = (uint32_t)(bend - c.o);
      if (!index_blocks(f)) { delete m; return nullptr; }
      m->funcs.push_back(f);
      c.o = bend;
    }
    if (c.fail) { delete m; return nullptr; }
  }
  return m;
}

}  // namespace

extern "C" {

void* wvm_load(const uint8_t* bytes, uint64_t n) {
  return parse(bytes, (size_t)n);
}

void wvm_free(void* h) { delete (Module*)h; }

// Multi-value call: writes up to nret results into ret, returns the result
// count (>= 0) on success; -1 unknown export; -2 arity mismatch; -3 ret too
// small; -(1000 + code) on a trap (code 99 = wasm-bindgen throw, 100+c =
// circom exceptionHandler with code c).
int wvm_call_multi(void* h, const char* name, const uint64_t* args, int nargs,
                   uint64_t* ret, int nret) {
  Module* m = (Module*)h;
  auto it = m->exports.find(name);
  if (it == m->exports.end() || it->second.kind != 0) return -1;
  const FuncType& ft = m->types[m->funcs[it->second.idx].type];
  if ((int)ft.params.size() != nargs) return -2;
  if ((int)ft.results.size() > nret) return -3;
  m->trap = 0;
  m->trap_msg.clear();
  VM vm(*m);
  Val rs[8] = {0};
  if (!vm.call(it->second.idx, args, rs))
    return -(1000 + (m->trap ? m->trap : 1));
  for (size_t i = 0; i < ft.results.size(); i++) ret[i] = rs[i];
  return (int)ft.results.size();
}

// Single-result convenience wrapper (the circom calculator protocol).
// Returns 0 on success; -1/-2 as above; >0 trap code (legacy contract).
int wvm_call(void* h, const char* name, const uint64_t* args, int nargs,
             uint64_t* ret) {
  uint64_t rs[8] = {0};
  int rc = wvm_call_multi(h, name, args, nargs, rs, 8);
  if (rc <= -1000) return -rc - 1000;
  if (rc < 0) return rc;
  if (rc > 0 && ret) *ret = rs[0];
  return 0;
}

uint32_t wvm_exception_code(void* h) { return ((Module*)h)->exception_code; }

// Last __wbindgen_throw message (empty if none); valid until the next call.
const char* wvm_trap_message(void* h) {
  return ((Module*)h)->trap_msg.c_str();
}

// Direct linear-memory access (bounds-checked) for bulk I/O.
int wvm_read_mem(void* h, uint32_t addr, uint8_t* out, uint32_t n) {
  Module* m = (Module*)h;
  if ((uint64_t)addr + n > m->mem.size()) return -1;
  memcpy(out, &m->mem[addr], n);
  return 0;
}

int wvm_write_mem(void* h, uint32_t addr, const uint8_t* src, uint32_t n) {
  Module* m = (Module*)h;
  if ((uint64_t)addr + n > m->mem.size()) return -1;
  memcpy(&m->mem[addr], src, n);
  return 0;
}

// ---- call tracing (reverse-engineering aid; see Frame::trace_hook) ----

// Trace calls to function `fi`; dump linear memory at args[ptr_arg] with
// length args[len_arg] (or fixed_len when len_arg < 0). ptr_arg < 0 = no dump.
int wvm_trace_add(void* h, uint32_t fi, int ptr_arg, int len_arg,
                  uint32_t fixed_len) {
  Module* m = (Module*)h;
  if (fi >= m->funcs.size()) return -1;
  m->trace_specs[fi] = {ptr_arg, len_arg, fixed_len};
  return 0;
}

// Like wvm_trace_add but records a second fixed-length region at args[p2]
// per call (each record then carries two length-prefixed dumps).
int wvm_trace_add2(void* h, uint32_t fi, int ptr_arg, int len_arg,
                   uint32_t fixed_len, int p2, uint32_t fixed_len2) {
  Module* m = (Module*)h;
  if (fi >= m->funcs.size()) return -1;
  m->trace_specs[fi] = {ptr_arg, len_arg, fixed_len, p2, fixed_len2};
  return 0;
}

void wvm_trace_clear(void* h) {
  Module* m = (Module*)h;
  m->trace_specs.clear();
  m->trace_log.clear();
}

uint64_t wvm_trace_size(void* h) { return ((Module*)h)->trace_log.size(); }

// Copy up to cap bytes of the trace log into out; returns bytes copied and
// clears the log.
uint64_t wvm_trace_copy(void* h, uint8_t* out, uint64_t cap) {
  Module* m = (Module*)h;
  uint64_t n = m->trace_log.size();
  if (n > cap) n = cap;
  if (n) memcpy(out, m->trace_log.data(), n);
  m->trace_log.clear();
  return n;
}

// Find defined functions whose body contains the exact byte pattern `pat`
// (e.g. an encoded i32.const). Writes up to cap indices; returns count.
int wvm_find_funcs_with_bytes(void* h, const uint8_t* pat, uint32_t patlen,
                              uint32_t* out, int cap) {
  Module* m = (Module*)h;
  int k = 0;
  for (uint32_t fi = 0; fi < m->funcs.size() && k < cap; fi++) {
    const Func& f = m->funcs[fi];
    if (!f.code || f.len < patlen) continue;
    for (uint64_t o = 0; o + patlen <= f.len; o++) {
      if (memcmp(f.code + o, pat, patlen) == 0) { out[k++] = fi; break; }
    }
  }
  return k;
}

// Number of functions (imports + defined) — for enumerating trace targets.
uint32_t wvm_n_funcs(void* h) { return (uint32_t)((Module*)h)->funcs.size(); }

}  // extern "C"

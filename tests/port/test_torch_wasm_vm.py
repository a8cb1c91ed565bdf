"""Port vs reference: the native WASM VM (zksc_tpu_torch/native/wasm_vm.cc
through native.wasm_lib vs the JAX package's build of its own copy) and the
wrappers over it (interop.circom_wasm, interop.stwo_wasm). A small module
assembled here by hand (i32 and i64 arithmetic, one memory with a data
segment, a multi-value function, an unreachable trap, a division by zero,
and a wasm-bindgen throw with a message) runs through wvm_load, wvm_call,
wvm_call_multi, wvm_read_mem / wvm_write_mem and wvm_trap_message of both
builds. The reference's own circuit.wasm and stwo WASM are not in the
checkout: their tests skip with the JAX tests' condition.

Tolerance: none (exact).
"""
import ctypes
import os
import random
from concurrent.futures import ThreadPoolExecutor

import pytest

from zksc_tpu.interop import circom_wasm as j_cw
from zksc_tpu.interop import stwo_wasm as j_sw
from zksc_tpu_torch import native
from zksc_tpu_torch.interop import circom_wasm as t_cw
from zksc_tpu_torch.interop import stwo_wasm as t_sw

I32, I64 = 0x7F, 0x7E


def _leb(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _sleb(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        done = (n == 0 and not b & 0x40) or (n == -1 and b & 0x40)
        out.append(b | (0 if done else 0x80))
        if done:
            return bytes(out)


def _vec(items) -> bytes:
    return _leb(len(items)) + b"".join(items)


def _name(s: str) -> bytes:
    return _leb(len(s)) + s.encode()


def _section(sid: int, payload: bytes) -> bytes:
    return bytes([sid]) + _leb(len(payload)) + payload


def _body(code: bytes, locals_=()) -> bytes:
    b = _vec([_leb(n) + bytes([t]) for n, t in locals_]) + code + b"\x0b"
    return _leb(len(b)) + b


MESSAGE = b"hello wasm"


def wasm_module() -> bytes:
    functype = lambda ps, rs: b"\x60" + _vec([bytes([p]) for p in ps]) + \
        _vec([bytes([r]) for r in rs])
    types = [functype([I32, I32], [I32]), functype([I64, I64], [I64]),
             functype([], []), functype([I32, I32], []),
             functype([I32], [I32, I32])]
    imports = [_name("wbg") + _name("__wbg___wbindgen_throw_0123") + b"\x00"
               + _leb(3)]
    get = lambda i: b"\x20" + _leb(i)
    # mix32(a, b): mem[32] = (a + b) * a ^ rotl(b, 5); return mem[32]
    mix32 = (b"\x41" + _sleb(32) + get(0) + get(1) + b"\x6a" + get(0)
             + b"\x6c" + get(1) + b"\x41" + _sleb(5) + b"\x77\x73"
             + b"\x36\x02\x00" + b"\x41" + _sleb(32) + b"\x28\x02\x00")
    # mix64(a, b) = a * b + rotl(a, 13) ^ (b >> 7)
    mix64 = (get(0) + get(1) + b"\x7e" + get(0) + b"\x42" + _sleb(13)
             + b"\x89\x7c" + get(1) + b"\x42" + _sleb(7) + b"\x88\x85")
    boom = b"\x00"                                       # unreachable
    div = get(0) + get(1) + b"\x6e"                      # i32.div_u
    throw = (b"\x41" + _sleb(16) + b"\x41" + _sleb(len(MESSAGE))
             + b"\x10" + _leb(0))                        # call the import
    pair = get(0) + get(0) + b"\x41" + _sleb(-7) + b"\x6b"
    funcs = [0, 1, 2, 0, 2, 4]
    names = ["mix32", "mix64", "boom", "div", "throw", "pair"]
    exports = [_name(n) + b"\x00" + _leb(i + 1) for i, n in enumerate(names)]
    exports.append(_name("memory") + b"\x02" + _leb(0))
    return (b"\x00asm\x01\x00\x00\x00"
            + _section(1, _vec(types))
            + _section(2, _vec(imports))
            + _section(3, _vec([_leb(t) for t in funcs]))
            + _section(5, _vec([b"\x00" + _leb(1)]))
            + _section(7, _vec(exports))
            + _section(10, _vec([_body(mix32), _body(mix64), _body(boom),
                                 _body(div), _body(throw), _body(pair)]))
            + _section(11, _vec([b"\x00\x41" + _sleb(16) + b"\x0b"
                                 + _vec([bytes([c]) for c in MESSAGE])])))


def _jax_lib():
    """The JAX package's build, with the extended signatures its stwo
    wrapper declares."""
    lib = j_cw._vm_lib()
    assert lib is not None, "g++ build of the JAX package's WASM VM failed"
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.wvm_call_multi.restype = ctypes.c_int
    lib.wvm_call_multi.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u64p,
                                   ctypes.c_int, u64p, ctypes.c_int]
    lib.wvm_trap_message.restype = ctypes.c_char_p
    lib.wvm_trap_message.argtypes = [ctypes.c_void_p]
    lib.wvm_read_mem.restype = ctypes.c_int
    lib.wvm_read_mem.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                 ctypes.POINTER(ctypes.c_uint8),
                                 ctypes.c_uint32]
    lib.wvm_write_mem.restype = ctypes.c_int
    lib.wvm_write_mem.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                  ctypes.c_char_p, ctypes.c_uint32]
    return lib


@pytest.fixture(scope="module")
def libs():
    with ThreadPoolExecutor(2) as ex:            # the two g++ builds at once
        jf, tf = ex.submit(_jax_lib), ex.submit(native.wasm_lib)
        return {"jax": jf.result(), "port": tf.result()}


def _drive(lib) -> list:
    """Every call of the module through one build: results, return codes,
    trap messages and memory reads, as one comparable list."""
    wasm = wasm_module()
    h = lib.wvm_load(wasm, len(wasm))
    assert h
    out = []
    rng = random.Random(5)

    def call(name, *args, nret=8):
        a = (ctypes.c_uint64 * max(1, len(args)))(*args)
        rets = (ctypes.c_uint64 * 8)()
        rc = lib.wvm_call_multi(h, name.encode(), a, len(args), rets, nret)
        msg = lib.wvm_trap_message(h)
        return rc, [int(rets[i]) for i in range(max(rc, 0))], msg

    def read(addr, n):
        buf = (ctypes.c_uint8 * n)()
        return lib.wvm_read_mem(h, addr, buf, n), bytes(buf)

    try:
        for _ in range(8):
            a, b = rng.randrange(1 << 32), rng.randrange(1 << 32)
            out.append(call("mix32", a, b))
            out.append(read(32, 4))
            x, y = rng.randrange(1 << 64), rng.randrange(1 << 64)
            out.append(call("mix64", x, y))
        one = ctypes.c_uint64(0)
        out.append(lib.wvm_call(h, b"mix32", (ctypes.c_uint64 * 2)(3, 4), 2,
                                ctypes.byref(one)))
        out.append(one.value)
        out += [call("pair", 5), call("pair", 3, nret=1), call("boom"),
                call("div", 7, 2), call("div", 7, 0), call("throw"),
                call("nope"), call("mix32", 1)]
        out.append(lib.wvm_call(h, b"boom", (ctypes.c_uint64 * 1)(), 0,
                                ctypes.byref(one)))
        out.append(lib.wvm_exception_code(h))
        out.append(read(16, len(MESSAGE)))
        out.append(lib.wvm_write_mem(h, 100, b"\x01\x02\x03", 3))
        out.append(read(99, 5))
        out.append(read(65536 - 2, 4))                    # out of bounds
        out.append(lib.wvm_write_mem(h, 65535, b"\x01\x02", 2))
    finally:
        lib.wvm_free(h)
    return out


def test_vm_builds_agree(libs):
    got = {k: _drive(lib) for k, lib in libs.items()}
    assert got["port"] == got["jax"]
    out = got["port"]
    rng = random.Random(5)
    M32, M64 = (1 << 32) - 1, (1 << 64) - 1
    rotl = lambda v, n, w: ((v << n) | (v >> (w - n))) & ((1 << w) - 1)
    for i in range(8):                           # the arithmetic itself
        a, b = rng.randrange(1 << 32), rng.randrange(1 << 32)
        want = (((a + b) * a) & M32) ^ rotl(b, 5, 32)
        assert out[3 * i][:2] == (1, [want])
        assert out[3 * i + 1] == (0, want.to_bytes(4, "little"))
        x, y = rng.randrange(1 << 64), rng.randrange(1 << 64)
        assert out[3 * i + 2][:2] == (1, [((x * y + rotl(x, 13, 64)) & M64)
                                          ^ (y >> 7)])
    (ok, one, pair, pair_short, boom, div_ok, div0, throw, unknown, arity,
     boom_rc, exc, data, wr, back, oob, wr_oob) = out[24:]
    assert (ok, one) == (0, (7 * 3) ^ rotl(4, 5, 32))
    assert pair[:2] == (2, [5, 12]) and pair_short[0] == -3
    assert boom[0] == -1001 and boom_rc == 1 and exc == 0
    assert div_ok[:2] == (1, [3]) and div0[0] <= -1000
    assert throw[0] == -1099 and throw[2] == MESSAGE
    assert unknown[0] == -1 and arity[0] == -2
    assert data == (0, MESSAGE)
    assert wr == 0 and back == (0, b"\x00\x01\x02\x03\x00")
    assert oob[0] == -1 and wr_oob == -1


def test_wrappers_reject_modules_alike(libs):
    wasm = wasm_module()
    for cw in (j_cw, t_cw):
        with pytest.raises(cw.CircomWasmError, match="unknown export"):
            cw.WitnessCalculator(wasm)
        with pytest.raises(cw.CircomWasmError, match="failed to parse"):
            cw.WitnessCalculator(b"\x00asm\x01\x00\x00\x00\x01\x05")
    for sw in (j_sw, t_sw):
        with pytest.raises(sw.StwoWasmError, match="call error -1"):
            sw.StwoWasm(wasm)


def test_wasm_lib_raises_when_gxx_fails(monkeypatch):
    monkeypatch.setattr(native, "_WASM_LIB", None)
    monkeypatch.setattr(native, "_stale", lambda src, out: True)
    monkeypatch.setattr(native, "_build", lambda src, out: "no compiler")
    with pytest.raises(RuntimeError, match="no compiler"):
        native.wasm_lib()


def test_witness_bit_serializers_equal():
    rng = random.Random(9)
    data = bytes(rng.randrange(256) for _ in range(64))
    assert t_cw._chacha_bits(data) == j_cw._chacha_bits(data)
    assert t_cw._be_bits(data) == j_cw._be_bits(data)
    for name in ("key", "nonce", "counter", "in", "main.out[3]"):
        assert t_cw.fnv1a64(name) == j_cw.fnv1a64(name)


# ---- the reference's own WASM files (absent from the checkout) ----

_RES = t_cw.reference_resources()


@pytest.mark.skipif(not os.path.isdir(os.path.join(_RES, "snarkjs")),
                    reason="reference snarkjs resources not present")
def test_reference_circom_witness_equal():
    from zksc_tpu_torch.ops.ciphers import chacha20_encrypt
    rng = random.Random(4)
    key, nonce = bytes(rng.randrange(256) for _ in range(32)), bytes(12)
    ct = chacha20_encrypt(key, nonce, 1, bytes(128))
    inputs = {"key": t_cw._chacha_bits(key), "nonce": t_cw._chacha_bits(nonce),
              "counter": [(1 >> (31 - j)) & 1 for j in range(32)],
              "in": t_cw._chacha_bits(ct)}
    tw = t_cw.load_reference_calculator("chacha20").calculate_witness(inputs)
    jw = j_cw.load_reference_calculator("chacha20").calculate_witness(inputs)
    assert tw == jw and tw[0] == 1


@pytest.mark.skipif(
    not os.path.exists(os.path.join(_RES, "stwo", "s2circuits_bg.wasm")),
    reason="reference stwo wasm not present")
def test_reference_stwo_equal():
    t, j = t_sw.load_reference_stwo(), j_sw.load_reference_stwo()
    assert t.get_circuits_info() == j.get_circuits_info()
    key, nonce = bytes(range(32)), bytes(range(12))
    assert t.debug_chacha20_keystream(key, nonce, 1) == \
        j.debug_chacha20_keystream(key, nonce, 1)

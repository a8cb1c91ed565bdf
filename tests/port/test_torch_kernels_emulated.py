"""The CUDA sources of K1, K2, K3, K7a-d and the Groth16 H kernels K0, K4,
K5 (zksc_tpu_torch/csrc/), run on the CPU.

No CUDA compiler exists here, so the sources are turned into plain C++ and
built with g++: each PTX asm block becomes C++ with an explicit carry flag
(the instructions the field core uses: mad/madc lo/hi, add/addc, sub/subc,
with .cc), each <<<grid, block>>> launch runs its blocks one after another
with one std::thread per CUDA thread, and __shfl_xor_sync / __syncthreads
become barriers between those threads (a lane pair's shuffle waits for both
threads, as the pair mask says; __shfl_sync and __any_sync wait for the
threads their mask names). The wrappers' launch paths
(ec_kernels._launch_*, msm_kernels._launch) then drive the emulated library
on CPU tensors, and every output is held to the kernel's plain PyTorch
version limb for limb, on crafted lanes (chip_smoke.craft: identity,
doubling, negation, affine and Jacobian Q in one warp) at lane counts that
leave a ragged last block and an unpaired warp tail for the two-thread G2
instances. The STARK kernels (K7a Blake2s from strided sources and its
one-launch Merkle tree, whose last block takes a ticket by an atomic add
that the shim runs under a mutex; K7b's four circle-FFT layer forms; K7c's
sliced composition over the chacha20 AIR's index groups at each launch
shape, and its summing launch on 2-D blocks; K7d's over the AES AIR with
its sigma gather) are held to their plain versions and K7a to hashlib;
K0 (to_mont and the quotient over a ragged last block), K4 (every
transform's stage groups split with a small tile at n = 2^8-2^10, so a
transform takes two or three launches) and K5 (empty and long rows, a
ragged last block) to theirs; the bucket MSM's glue K6a-d (the keys'
histogram in shared memory and in global memory, its atomics under the
shim's mutex; the sorted gather in both layouts; the top scan in one and
in two launches, with runs of one and of several lanes; the bucket
boundaries over two K1 levels and the top) to theirs, and a whole
_window_sums through the emulated K6, K1 and K2 to the plain one. This checks the kernels' indexing, layouts,
branches and the lane-pair protocol; the card's own compiler and timing are
chip_smoke.py's."""
import ctypes
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(ROOT, "zksc_tpu_torch", "csrc")
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from zksc_tpu_torch.fields.limb import Fr  # noqa: E402
from zksc_tpu_torch.ops import ec, ec_kernels, msm, msm_kernels  # noqa: E402
from zksc_tpu_torch.ops import h_kernels, msm_glue, stark_kernels  # noqa: E402
from zksc_tpu_torch.ops.ntt import NTTContext  # noqa: E402
from zksc_tpu_torch.stark import aes_air, blake2s, chacha_air, circle  # noqa: E402
from zksc_tpu_torch.stark import aes_prover  # noqa: E402
from zksc_tpu_torch.stark import prover as stark_prover  # noqa: E402

SHIM = r'''
#pragma once
#include <atomic>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __constant__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__ static
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3e { unsigned x, y, z; };
inline thread_local uint3e threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetLastError() { return 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) { std::memset(p, v, n); return 0; }
template <class K> inline int cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
struct BlockCtx {
  std::unique_ptr<std::barrier<>> all;
  std::vector<std::unique_ptr<std::barrier<>>> pairs;
  std::mutex mu;
  std::map<std::pair<unsigned, unsigned>, std::unique_ptr<std::barrier<>>> groups;
  std::vector<uint64_t> slot;
  std::vector<char> smem;
};
inline thread_local BlockCtx* g_blk = nullptr;
inline void __syncthreads() { g_blk->all->arrive_and_wait(); }
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned n) {
  n &= 31u;
  return n ? (uint32_t)((((uint64_t)hi << 32) | lo) >> n) : lo;
}
template <class T> inline T __shfl_xor_sync(unsigned mask, T v, int lanemask) {
  const unsigned t = threadIdx.x;
  if (lanemask != 1 || mask != (3u << (t & 30u))) { fprintf(stderr, "unexpected shuffle\n"); abort(); }
  auto& b = *g_blk->pairs[t / 2];
  g_blk->slot[t] = (uint64_t)v;
  b.arrive_and_wait();
  T r = (T)g_blk->slot[t ^ 1u];
  b.arrive_and_wait();
  return r;
}
// the threads of one warp that `mask` names meet at a barrier of their own
inline std::barrier<>& group_barrier(unsigned mask) {
  std::lock_guard<std::mutex> lock(g_blk->mu);
  auto& b = g_blk->groups[{threadIdx.x / 32u, mask}];
  if (!b) b = std::make_unique<std::barrier<>>(__builtin_popcount(mask));
  return *b;
}
template <class T> inline T __shfl_sync(unsigned mask, T v, int src) {
  const unsigned t = threadIdx.x;
  if (!((mask >> (t & 31u)) & 1u) || !((mask >> src) & 1u)) { fprintf(stderr, "unexpected shuffle\n"); abort(); }
  auto& b = group_barrier(mask);
  g_blk->slot[t] = (uint64_t)v;
  b.arrive_and_wait();
  T r = (T)g_blk->slot[(t & ~31u) + (unsigned)src];
  b.arrive_and_wait();
  return r;
}
inline bool __any_sync(unsigned mask, bool p) {
  const unsigned t = threadIdx.x;
  auto& b = group_barrier(mask);
  g_blk->slot[t] = p;
  b.arrive_and_wait();
  bool r = false;
  for (unsigned i = 0; i < 32; ++i)
    if ((mask >> i) & 1u) r = r || g_blk->slot[(t & ~31u) + i] != 0;
  b.arrive_and_wait();
  return r;
}
inline char* dyn_smem() { return g_blk->smem.data(); }
inline size_t __cvta_generic_to_shared(const void*) { return 0; }
// device-scope atomics and fences: one mutex; blocks run one after another
inline std::mutex g_atomic_mu;
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  std::lock_guard<std::mutex> lock(g_atomic_mu);
  const unsigned old = *p;
  *p = old + v;
  return old;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
template <class T> inline T __ldcg(const T* p) { return *(const volatile T*)p; }
inline void zk_launch(dim3 grid, dim3 block, size_t smem, std::function<void()> body) {
  gridDim = grid; blockDim = block;
  const unsigned n = block.x * block.y;
  for (unsigned by = 0; by < grid.y; ++by)
  for (unsigned b = 0; b < grid.x; ++b) {
    BlockCtx ctx;
    ctx.all = std::make_unique<std::barrier<>>(n);
    for (unsigned i = 0; i < n / 2; ++i) ctx.pairs.push_back(std::make_unique<std::barrier<>>(2));
    ctx.slot.resize(n);
    ctx.smem.resize(smem + 16);
    std::vector<std::thread> th;
    for (unsigned t = 0; t < n; ++t)
      th.emplace_back([&, t, b, by] {
        threadIdx = {t % block.x, t / block.x, 0}; blockIdx = {b, by, 0}; g_blk = &ctx; body(); });
    for (auto& x : th) x.join();
  }
}
'''


def _ptx_to_cpp(block: str) -> str:
    """One asm statement's body -> C++ with an explicit carry flag."""
    if "cp.async.ca" in block:              # a 4-byte global -> shared copy
        return "*(smem_dst) = *(src);"
    if "cp.async" in block:                 # commit / wait: copies are synchronous here
        return ";"
    parts = block.split(":")
    tmpl = "".join(re.findall(r'"([^"]*)"', parts[0]))
    ops = []
    for part in parts[1:3]:
        ops += re.findall(r'"[=+]?r"\(([^)]*)\)', part)
    code = ["{ uint64_t cf_ = 0, t_;"]

    def v(tok):
        return (f"(uint64_t)({ops[int(tok[1:])]})" if tok.startswith("%")
                else f"(uint64_t){tok}u")

    for ins in (s.strip() for s in tmpl.replace("\\n", "").replace("\\t", "")
                .split(";")):
        if not ins:
            continue
        op, args = ins.split(None, 1)
        args = [a.strip() for a in args.split(",")]
        d, s = ops[int(args[0][1:])], [v(a) for a in args[1:]]
        p = op.split(".")
        base, cc = p[0], "cc" in p
        if base in ("mad", "madc"):
            prod = f"({s[0]} * {s[1]})"
            e = (f"({prod} >> 32)" if "hi" in p else f"({prod} & 0xffffffffull)") \
                + f" + {s[2]}" + (" + cf_" if base == "madc" else "")
            carry = "cf_ = t_ >> 32;"
        elif base in ("add", "addc"):
            e = f"{s[0]} + {s[1]}" + (" + cf_" if base == "addc" else "")
            carry = "cf_ = t_ >> 32;"
        elif base in ("sub", "subc"):
            e = f"{s[0]} - {s[1]}" + (" - cf_" if base == "subc" else "")
            carry = "cf_ = t_ >> 63;"
        else:
            raise ValueError(f"no emulation for {ins}")
        code.append(f"t_ = {e}; {d} = (uint32_t)t_;" + (f" {carry}" if cc else ""))
    code.append("}")
    return " ".join(code)


def _translate(src: str) -> str:
    out, i = [], 0
    while True:
        j = src.find("asm volatile(", i)
        if j < 0:
            out.append(src[i:])
            break
        k = src.index(");", j)
        out += [src[i:j], _ptx_to_cpp(src[j + len("asm volatile("):k])]
        i = k + 2
    s = "".join(out)
    s = re.sub(r"([\w:<>, ]+?)<<<([^>]*)>>>\(([^;]*)\);",
               lambda m: "zk_launch(%s, [&](){ %s(%s); });" % (
                   ", ".join(a.strip() for a in m.group(2).split(",")[:3]),
                   m.group(1).strip(), m.group(3)), s)
    s = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
               r"\1* \2 = (\1*)dyn_smem();", s)
    return s.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"')


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """(ec, msm, stark, h, msm_glue libraries) built from csrc/ with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the emulated kernels cannot be built")
    d = tmp_path_factory.mktemp("cuda_emu")
    (d / "cuda_shim.h").write_text(SHIM)
    for name in os.listdir(CSRC):
        (d / name).write_text(_translate(open(os.path.join(CSRC, name)).read()))
    libs = []
    for name in ("ec_kernels", "msm_kernels", "stark_kernels", "h_kernels",
                 "msm_glue"):
        so = d / f"lib{name}.so"
        subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-x", "c++",
                        str(d / f"{name}.cu"), "-o", str(so)], check=True,
                       capture_output=True, text=True, timeout=300)
        libs.append(ctypes.CDLL(str(so)))
    ec_kernels._declare(libs[0])
    msm_kernels._declare(libs[1])
    stark_kernels._declare(libs[2])
    h_kernels._declare(libs[3])
    msm_glue._declare(libs[4])
    return libs


@pytest.fixture
def kernels(emulated, monkeypatch):
    """The wrappers' launch paths, pointed at the emulated libraries."""
    monkeypatch.setattr(ec_kernels, "_lib", lambda: emulated[0])
    monkeypatch.setattr(msm_kernels, "_lib", lambda: emulated[1])
    monkeypatch.setattr(ec_kernels, "_stream", lambda t: None)
    monkeypatch.setattr(msm_kernels, "_stream", lambda t: None)
    monkeypatch.setattr(ec_kernels, "_require_cuda", lambda t, what: None)
    return ec_kernels


@pytest.fixture(scope="module")
def points():
    return chip_smoke.load_points("cpu")


def _fops(g2):
    return ec.G2_OPS if g2 else ec.G1_OPS


def _pair(points, g2, n, seed):
    g1a, g1b, g2h = points
    if g2:
        P, Q = chip_smoke.g2_lanes(g2h, 0, n), chip_smoke.g2_lanes(g2h, n, 2 * n)
    else:
        P, Q = chip_smoke.g1_lanes(g1a, 0, n), chip_smoke.g1_lanes(g1b, 0, n)
    return chip_smoke.craft(_fops(g2), P, Q, seed=seed)


def _cut(fops, A, n):
    return ec.JacPoint(*(fops.lane_map(lambda a: a[:, :n].contiguous(), c)
                         for c in A))


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g.to(torch.int32), w.to(torch.int32))


@pytest.mark.parametrize("complete", [True, False])
@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_k2_emulated(kernels, points, g2, complete):
    """K2 at 512 lanes and 449 (a ragged block; for G2 an unpaired warp
    tail), and on the halving reduce's views, against jac_add_n_plain."""
    fops = _fops(g2)
    P, Q = _pair(points, g2, 512, seed=1 + g2)
    for n in (512, 449):
        Pn, Qn = _cut(fops, P, n), _cut(fops, Q, n)
        _equal(kernels._launch_jac_add_n(fops, Pn, Qn, complete),
               ec_kernels.jac_add_n_plain(fops, Pn, Qn, complete))
    n = 512

    def join(p, q):
        if not g2:
            return torch.cat([p, q], dim=-1)
        return torch.cat([p[:, :n], q[:, :n], p[:, n:], q[:, n:]], dim=-1)
    W = ec.JacPoint(*(join(p, q) for p, q in zip(P, Q)))
    lo, hi = msm._lane_range(fops, W, 0, n), msm._lane_range(fops, W, n, 2 * n)
    _equal(kernels._launch_jac_add_n(fops, lo, hi, complete),
           ec_kernels.jac_add_n_plain(fops, P, Q, complete))


@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_k1_emulated(kernels, points, g2, inclusive):
    """K1 on the step-major layout, C = 29 chunks of S = 16 (not a multiple
    of any block), and C = 32 with the totals written for a next level of
    16; crafted pairs in consecutive steps of a chunk."""
    fops = _fops(g2)
    S = 16
    A, B = _pair(points, g2, 32 * S, seed=3 + g2)
    for C, steps in ((29, 1), (32, 16)):
        pts = chip_smoke.k1_input(fops, A, B, C, S)
        got = kernels._launch_chunk_scan(fops, pts, S, inclusive, steps)
        want = ec_kernels.chunk_scan_plain(fops, pts, S, inclusive, steps)
        _equal(got[0], want[0])
        _equal(got[1], want[1])


@pytest.mark.parametrize("layout", ["LANE", "SPLIT"])
@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_k3_emulated(kernels, points, g2, layout):
    """K3 in each layout over 128 lanes x 10 bits (chip_smoke.ladder_inputs:
    zero and one scalars, identity points, Jacobian points, equal and
    opposite points meeting in the reduction), with per-lane and shared
    bits, unreduced and reduced over segments of 64 and of all 128 lanes
    (SPLIT: a LANE relaunch reduces); then unreduced over 101 lanes, which
    leaves a partial last warp in every layout (SPLIT: 8 lanes a G1 warp,
    4 a G2 warp; its idle lane groups return before any shuffle)."""
    fops = _fops(g2)
    lay = getattr(msm_kernels, layout)
    g1a, _, g2h = points
    P = chip_smoke.g2_lanes(g2h, 0, 128) if g2 else chip_smoke.g1_lanes(g1a, 0, 128)
    P, bits = chip_smoke.ladder_inputs(fops, P, 10, seed=11)
    shared = bits[:, 7].contiguous()
    for b, seg in ((bits, None), (bits, 64), (bits, 128), (shared, None)):
        got = msm_kernels._ladder(fops, P, b, 10, seg, lay)
        _equal(got, msm_kernels.ladder_plain(fops, P, b, 10, seg))
    P, b = _cut(fops, P, 101), bits[:, :101].contiguous()
    _equal(msm_kernels._ladder(fops, P, b, 10, None, lay),
           msm_kernels.ladder_plain(fops, P, b, 10))


def test_k3_layout_by_shape(monkeypatch):
    """The wrapper picks K3's layout from the lane count alone: SPLIT for
    the ladder branch's 128-lane MSMs and up to SPLIT_MAX_LANES, LANE for
    the ceremony's 2^16-2^18 lanes;
    a reduced SPLIT ladder is one unreduced SPLIT launch and LANE
    relaunches over groups of up to 128 lanes, a reduced LANE ladder
    reduces its first group in the ladder launch."""
    plan = []

    def fake_launch(fops, P, bits, n_bits, run_ladder, group, layout=0):
        plan.append((layout, group, run_ladder))
        return P
    monkeypatch.setattr(msm_kernels, "_launch", fake_launch)
    LANE, SPLIT = msm_kernels.LANE, msm_kernels.SPLIT
    top = msm_kernels.SPLIT_MAX_LANES
    for n, want in ((1, SPLIT), (128, SPLIT), (top, SPLIT), (top + 1, LANE),
                    (1 << 16, LANE), (1 << 18, LANE)):
        assert msm_kernels._layout(n) == want
    for layout, seg, want in (
            (SPLIT, 128, [(SPLIT, 1, True), (LANE, 128, False)]),
            (SPLIT, 4096, [(SPLIT, 1, True), (LANE, 128, False), (LANE, 32, False)]),
            (SPLIT, None, [(SPLIT, 1, True)]),
            (LANE, 128, [(LANE, 128, True)]),
            (LANE, 4096, [(LANE, 128, True), (LANE, 32, False)]),
            (LANE, None, [(LANE, 1, True)])):
        plan.clear()
        msm_kernels._ladder(ec.G1_OPS, None, None, 254, seg, layout)
        assert plan == want


@pytest.mark.parametrize("name, constant", [("GROUP", "kLaneLanes"),
                                            ("ROLES", "kRoles")])
def test_k3_constants_match_source(name, constant):
    """The wrapper's copies of K3's constants (the reduction group, the
    threads per SPLIT lane that chip_smoke's chain floor counts) are the
    kernel's own."""
    src = open(os.path.join(CSRC, "msm_kernels.cu")).read()
    m = re.search(rf"constexpr int {constant} = (\d+);", src)
    assert m and int(m.group(1)) == getattr(msm_kernels, name)


@pytest.fixture
def stark_emu(emulated, monkeypatch):
    """stark_kernels' launch paths, pointed at the emulated library."""
    monkeypatch.setattr(stark_kernels, "_lib", lambda: emulated[2])
    monkeypatch.setattr(stark_kernels, "_stream", lambda t: None)
    monkeypatch.setattr(stark_kernels, "_require_cuda", lambda t, what: None)
    return stark_kernels


def test_k7a_emulated(stark_emu):
    """K7a over 8 messages at lengths 0-200 bytes (partial last words and
    blocks, an empty message), from a contiguous source, from the columns
    of a [words, 8] matrix (word stride 8, message stride 1, as the trace
    commitment reads the LDE) and as a Merkle pair layer (message stride
    16): equal to the plain version and to hashlib."""
    import hashlib
    import numpy as np
    rng = np.random.default_rng(7)
    for length in (0, 1, 63, 64, 65, 200):
        nw = max(1, -(-length // 4))
        words = torch.from_numpy(rng.integers(-2**31, 2**31, (nw, 8),
                                              dtype=np.int64).astype(np.int32))
        for base, ms, ws in ((words.T.contiguous(), nw, 1), (words, 1, 8)):
            got = stark_emu.blake2s(base, 8, length, ms, ws)
            assert torch.equal(got, blake2s.hash_strided_plain(base, 8, length, ms, ws))
            msgs = words.T.contiguous().numpy().view(np.uint8)[:, :length]
            for i in range(8):
                assert got[i].numpy().tobytes() == hashlib.blake2s(
                    msgs[i].tobytes(), digest_size=32).digest()
    layer = torch.from_numpy(rng.integers(-2**31, 2**31, (16, 8),
                                          dtype=np.int64).astype(np.int32))
    got = stark_emu.blake2s(layer, 8, 64, 16, 1)
    assert torch.equal(got, blake2s.hash_strided_plain(layer, 8, 64, 16, 1))


def _hashlib_tree(msgs):
    """Every layer of the Merkle tree over the byte strings `msgs`, by
    hashlib: [N, 32] uint8 arrays, leaves first."""
    import hashlib
    import numpy as np
    layer = [hashlib.blake2s(m, digest_size=32).digest() for m in msgs]
    layers = [layer]
    while len(layer) > 1:
        layer = [hashlib.blake2s(layer[2 * i] + layer[2 * i + 1],
                                 digest_size=32).digest()
                 for i in range(len(layer) // 2)]
        layers.append(layer)
    return [np.frombuffer(b"".join(x), dtype=np.uint8).reshape(-1, 32)
            for x in layers]


def _tree_layers(flat, n):
    import numpy as np
    flat = flat.numpy().view(np.uint8)
    out, at = [], 0
    while n >= 1:
        out.append(flat[at:at + n])
        at, n = at + n, n // 2
    return out


@pytest.mark.parametrize("n_leaves, words", [(256, 80), (256, 1), (8, 17),
                                             (64, 0)])
def test_k7a_tree_columns_emulated(stark_emu, n_leaves, words):
    """K7a's tree launch over the columns of an int32 [words, N] tensor
    (the trace commitment's form): 2^8 leaves of 320 bytes (5 message
    blocks; 8 blocks of 32 leaves, the top layers by the last block) and
    of 4 bytes, 8 leaves (one block of 8), 64 empty leaves. Every layer
    equals hashlib's and the plain version's."""
    import numpy as np
    rng = np.random.default_rng(n_leaves + words)
    cols = torch.from_numpy(rng.integers(-2**31, 2**31, (max(words, 1), n_leaves),
                                         dtype=np.int64).astype(np.int32))
    length = 4 * words
    got = stark_emu.blake2s_tree(cols, n_leaves, length, 1, n_leaves)
    assert torch.equal(got, blake2s.tree_strided_plain(cols, n_leaves, length,
                                                       1, n_leaves))
    msgs = [np.ascontiguousarray(cols.numpy()[:, i]).tobytes()[:length]
            for i in range(n_leaves)]
    for a, b in zip(_tree_layers(got, n_leaves), _hashlib_tree(msgs),
                    strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_leaves", [256, 2, 1])
def test_k7a_tree_rows_emulated(stark_emu, n_leaves):
    """K7a's tree launch over 16-byte rows (FRI's leaves: message stride
    4, word stride 1): 2^8 leaves, 2 and 1. Every layer equals hashlib's,
    also when the launch finds its ticket non-zero (as a launch that
    stopped before its last block would leave it): the ticket is zeroed
    before each launch."""
    import numpy as np
    rows = np.random.default_rng(n_leaves).integers(0, 256, (n_leaves, 16),
                                                    dtype=np.uint8)
    words = torch.from_numpy(rows.view(np.int32).copy())
    for stale in (5, -1):
        stark_emu._ticket(words).fill_(stale)
        got = stark_emu.blake2s_tree(words, n_leaves, 16, 4, 1)
        for a, b in zip(_tree_layers(got, n_leaves),
                        _hashlib_tree([r.tobytes() for r in rows]), strict=True):
            np.testing.assert_array_equal(a, b)


def test_k7a_tree_through_merkle(stark_emu, monkeypatch):
    """merkle.commit_columns and merkle.commit on the device path (the
    tree launch, one copy of its layers) give the host path's tree, layer
    for layer."""
    import numpy as np
    from zksc_tpu_torch.stark import merkle
    monkeypatch.setattr(merkle, "tree_strided", lambda *a: stark_emu.blake2s_tree(*a))
    rng = np.random.default_rng(9)
    cols = torch.from_numpy(rng.integers(0, 2**31 - 1, (6, 64)).astype(np.int32))
    want = merkle.commit_columns(cols)
    got = merkle._tree_device(cols, 64, 24, 1, 64)
    leaves = rng.integers(0, 256, (128, 16), dtype=np.uint8)
    for g, w in ((got, want), (merkle._tree_device(
            torch.from_numpy(leaves.view(np.int32).copy()), 128, 16, 4, 1),
            merkle.commit(leaves, device="cpu"))):
        assert len(g.layers) == len(w.layers)
        for a, b in zip(g.layers, w.layers):
            np.testing.assert_array_equal(a, b)


def _cut_groups(groups, keep):
    """The first keep[g] constraints of each of K7c's index groups."""
    out = {}
    for (name, fields), k in zip(stark_kernels.GROUP_FIELDS, keep):
        g = groups[name]
        out[name] = g[:k] if fields == (None,) else {f: g[f][:k] for f in g}
    return out


@pytest.mark.parametrize("wide", [False, True], ids=["off32", "off64"])
@pytest.mark.parametrize("M", [32, 64, 512])
def test_k7c_emulated_plans(stark_emu, monkeypatch, M, wide):
    """K7c at each launch shape composition_plan picks: M = 32 (one point
    a thread, a warp tile, slices of 32), 64 (two points a thread, slices
    of 32) and 512 (four points, 128-thread tiles, slices of 64), on 235
    constraints of the chacha20 AIR's groups, so the last slice is ragged
    and slices straddle groups; with 32-bit gather offsets and with the
    64-bit ones (WIDE_OFFSETS_FROM lowered to 0). Equal to
    _composition_plain."""
    import numpy as np
    if wide:
        monkeypatch.setattr(stark_kernels, "WIDE_OFFSETS_FROM", 0)
    n_comm, groups = chacha_air.layout()
    groups = _cut_groups(groups, (70, 50, 45, 40, 30))
    rng = np.random.default_rng(M)
    R = n_comm + chacha_air.N_PUBLIC + 1
    rand = lambda *shape: torch.from_numpy(
        rng.integers(0, (1 << 31) - 1, shape).astype(np.int32))
    vals, vn_inv = rand(R, M), rand(M)
    weights = rand(235, 4)
    idx, off, n = stark_kernels.pack_groups(groups)
    got = stark_emu.composition(vals, torch.from_numpy(idx), off, n, weights,
                                vn_inv)
    assert torch.equal(got, stark_prover._composition_plain(vals, groups,
                                                            weights, vn_inv))


def test_k7c_plan_by_shape():
    """composition_plan at the paths' M: the stwo chunk's 32 points run one
    point a thread in a warp tile and slices of 32; M = 512-2,048 four
    points a thread in 128-thread tiles and slices of 64."""
    plan = stark_kernels.composition_plan
    assert plan(32) == (32, 1, 32)
    assert plan(64) == (32, 2, 32)
    for M in (512, 1024, 2048, 8192):
        assert plan(M) == (64, 4, 128)


@pytest.mark.parametrize("log_n", [2, 3, 5])
def test_k7b_emulated(stark_emu, log_n):
    """K7b: interpolate and evaluate as log N layer launches (the y-fold and
    x-folds of each) over 3 columns, equal to the plain versions."""
    import numpy as np
    fft = circle.CircleFFT(log_n)
    x = torch.from_numpy(np.random.default_rng(log_n).integers(
        0, (1 << 31) - 1, (3, 1 << log_n)).astype(np.int32))
    for interp in (True, False):
        got = fft._transform(x, interp, stark_kernels.circle_layer)
        assert torch.equal(got, fft._plain(x, interp))


def _m31_cols(rng, C, n):
    return torch.from_numpy(rng.integers(0, (1 << 31) - 1, (C, n)).astype(np.int32))


@pytest.mark.parametrize("log_n", [2, 3, 4, 5, 6])
def test_k7b_fft_emulated(stark_emu, log_n):
    """K7b's one-launch transform at N = 4-64 (one column a 1-16-thread
    group, 16-256 columns a block) over a ragged last block: interpolate
    and evaluate (K = N), the x-layers two at a time and an odd one alone
    (log N - 1 x-layers: one at N = 4, a pair at 8, a pair and one at 16),
    equal to the plain versions; interpolate then evaluate gives back the
    input; each one launch."""
    fft = circle.CircleFFT(log_n)
    N = 1 << log_n
    C = 1024 // N + 3                         # a block and a ragged one
    x = _m31_cols(np.random.default_rng(log_n), C, N)
    x[0, :3] = torch.tensor([0, 1, (1 << 31) - 2], dtype=torch.int32)
    for interp in (True, False):
        before = stark_emu.LAUNCHES["circle_layer"]
        got = fft._kernels(x, interp)
        assert stark_emu.LAUNCHES["circle_layer"] == before + 1
        assert torch.equal(got, fft._plain(x, interp))
    assert torch.equal(fft._kernels(fft._kernels(x, True), False), x)


@pytest.mark.parametrize("K", [0, 1, 3, 8, 12, 16, 17, 31, 32])
def test_k7b_fft_emulated_short(stark_emu, K):
    """Evaluate from K < N = 32 coefficients a column (the rest zero: the
    x-layers whose upper half is zero copy), with 16-byte loads (K a
    multiple of 4) and without (K odd, or the input at a 4-byte offset):
    equal to the plain version of the zero-extended input."""
    fft = circle.CircleFFT(5)
    rng = np.random.default_rng(K)
    x = _m31_cols(rng, 19, K)
    full = torch.zeros((19, 32), dtype=torch.int32)
    full[:, :K] = x
    want = fft._plain(full, False)
    assert torch.equal(fft._kernels(x, False), want)
    assert torch.equal(fft.evaluate_plain(x), want)
    flat = torch.cat([torch.zeros(1, dtype=torch.int32), x.reshape(-1)])
    shifted = flat[1:].view(19, K)            # data_ptr 4 bytes past alignment
    assert torch.equal(fft._kernels(shifted, False), want)


def test_k7b_shape_rule(stark_emu, monkeypatch):
    """CircleFFT takes one circle_fft launch up to 2^FFT_MAX_LOG values and
    one circle_layer launch a layer above it (the limit lowered to 2^4
    here, so N = 32 takes the layer route), with the same values; the
    layer route zero-extends a short coefficient block."""
    monkeypatch.setattr(stark_kernels, "FFT_MAX_LOG", 4)
    calls = []
    for name in ("circle_fft", "circle_layer"):
        fn = getattr(stark_kernels, name)
        monkeypatch.setattr(stark_kernels, name,
                            lambda *a, _n=name, _f=fn: calls.append(_n) or _f(*a))
    rng = np.random.default_rng(5)
    for log_n, route, n_launch in ((4, "circle_fft", 1), (5, "circle_layer", 5)):
        fft = circle.CircleFFT(log_n)
        x = _m31_cols(rng, 6, 1 << log_n)
        for interp, src in ((True, x), (False, x), (False, x[:, :12].contiguous())):
            calls.clear()
            got = fft._kernels(src, interp)
            assert calls == [route] * n_launch
            assert torch.equal(got, fft._plain(fft._zero_extend(src), interp))


def test_k7c_emulated(stark_emu):
    """K7c on the chacha20 AIR's index groups (53,504 constraints in 1,672
    slices of 32) at M = 32 random values, weights and V_N inverses: equal
    to _composition_plain."""
    import numpy as np
    n_comm, groups = chacha_air.layout()
    rng = np.random.default_rng(3)
    R, M = n_comm + chacha_air.N_PUBLIC + 1, 32
    rand = lambda *shape: torch.from_numpy(
        rng.integers(0, (1 << 31) - 1, shape).astype(np.int32))
    vals, vn_inv = rand(R, M), rand(M)
    weights = rand(stark_prover._n_constraints(groups), 4)
    idx, off, n = stark_kernels.pack_groups(groups)
    got = stark_emu.composition(vals, torch.from_numpy(idx), off, n, weights,
                                vn_inv)
    assert torch.equal(got, stark_prover._composition_plain(vals, groups,
                                                            weights, vn_inv))


def test_k7c_emulated_stwo_layout(stark_emu):
    """K7c on the stark-stwo AIR's index groups (54,784 constraints in
    1,712 slices of 32, an empty addx group, the carry into bit 0 read from the zero
    row) at M = 32, the 128-byte chunk's: equal to _composition_plain."""
    import numpy as np
    from zksc_tpu_torch.stark.stwo_compat import air
    groups = air.layout()[0]
    rng = np.random.default_rng(4)
    rand = lambda *shape: torch.from_numpy(
        rng.integers(0, (1 << 31) - 1, shape).astype(np.int32))
    vals, vn_inv = rand(air.N_COLS + 1, 32), rand(32)
    vals[air.ZERO_ROW] = 0
    weights = rand(air.N_CONSTRAINTS, 4)
    idx, off, n = stark_kernels.pack_groups(groups)
    got = stark_emu.composition(vals, torch.from_numpy(idx), off, n, weights,
                                vn_inv)
    assert torch.equal(got, stark_prover._composition_plain(vals, groups,
                                                            weights, vn_inv))


def _k7d_inputs(key_size, M, seed):
    n1, n2, groups = aes_air.layout(key_size)
    rng = np.random.default_rng(seed)
    R = n1 + n2 + aes_air.N_PUB + 1
    rand = lambda *shape: torch.from_numpy(
        rng.integers(0, (1 << 31) - 1, shape).astype(np.int32))
    vals, vn_inv = rand(R, M), rand(M)
    vals[-1] = 0
    weights = rand(aes_prover.n_constraints(key_size), 4)
    za = tuple(int(v) for v in rng.integers(0, (1 << 31) - 1, 8))
    perm = torch.from_numpy(aes_air.sigma_perm(M, M // 8))
    want = aes_prover._composition_plain(vals, perm, groups, za[:4], za[4:],
                                         weights, vn_inv)
    return (vals, perm, aes_prover._groups_on(key_size, torch.device("cpu")),
            za, weights, vn_inv), want


@pytest.mark.parametrize("key_size", [16, 32])
def test_k7d_emulated(stark_emu, key_size):
    """K7d on the AES AIR's index groups (AES-128: 11,272 constraints in
    the slices aes_slices cuts by gathers, the cum sum spread over 160
    cumlk items; AES-256: 15,624) at M = 32 (N = 8, so sigma shifts by 4
    points) on random values, challenges, weights and V_N inverses, in the
    plan the wrapper picks: equal to _composition_plain, which covers the
    sigma gather, the interleaved lookup weights and the split cum sum."""
    args, want = _k7d_inputs(key_size, 32, key_size)
    assert torch.equal(stark_emu.aes_composition(*args), want)


@pytest.mark.parametrize("wide", [False, True], ids=["off32", "off64"])
@pytest.mark.parametrize("slices_first", [False, True], ids=["tiles", "slices"])
@pytest.mark.parametrize("M", [32, 64, 512])
def test_k7d_emulated_plans(stark_emu, monkeypatch, M, slices_first, wide):
    """K7d at each points-a-thread form aes_composition_plan picks: M = 32
    (one point, scalar gathers, a warp tile), 64 (two, 8-byte gathers) and
    512 (four, 16-byte gathers, a 128-thread tile; one value a point at
    sigma x in each), in both grid orders (AES_SLICES_FIRST_TILES lowered
    to 1 for the slices of a tile first), with 32-bit gather offsets (the
    rows times M staged) and 64-bit ones (WIDE_OFFSETS_FROM lowered to 0),
    over the AES-128 AIR: equal to _composition_plain."""
    if wide:
        monkeypatch.setattr(stark_kernels, "WIDE_OFFSETS_FROM", 0)
    if slices_first:
        monkeypatch.setattr(stark_kernels, "AES_SLICES_FIRST_TILES", 1)
    points, threads = {32: (1, 32), 64: (2, 32), 512: (4, 128)}[M]
    assert stark_kernels.aes_composition_plan(M) == (points, threads, slices_first)
    args, want = _k7d_inputs(16, M, M + points)
    assert torch.equal(stark_emu.aes_composition(*args), want)


def test_k7d_plan_by_shape():
    """aes_composition_plan at the AES paths' M: four points a thread in
    128-thread tiles from M = 512 (composition_plan's); the point tiles of
    a slice first while the tiles are few (M = 2,048: 4), the slices of a
    tile first from AES_SLICES_FIRST_TILES tiles (M = 8,192: 16)."""
    plan = stark_kernels.aes_composition_plan
    assert plan(2048) == (4, 128, False)
    assert plan(8192) == (4, 128, True)
    assert plan(32768) == (4, 128, True)


def test_k7d_slice_table():
    """aes_slice_table: each slice stages its items' rows kind by kind
    (field-major), within AES_ROWS_MAX, and names weight rows that cover
    its items' (a lookup's four, the cum column's four for cum and every
    cumlk); the cumlk items of the AES-128 AIR fall into several slices,
    each slice gathering no more than AES_SLICE_GATHERS values."""
    _, _, groups = aes_air.layout(16)
    idx, off, n, rows = stark_kernels.pack_aes_groups(groups)
    bounds = stark_kernels.aes_slices(n)
    hdr, srows = stark_kernels.aes_slice_table(idx, off, n, rows, bounds)
    kinds = stark_kernels.AES_KINDS
    assert hdr.shape == (len(bounds) - 1, stark_kernels.AES_HDR)
    assert hdr[:, 1].sum() == srows.size and (hdr[:, 1] <= stark_kernels.AES_ROWS_MAX).all()
    assert (np.diff(hdr[:, 0]) == hdr[:-1, 1]).all()
    cumlk = kinds.index("cumlk")
    assert (hdr[:, 4 + 3 * cumlk] > 0).sum() >= 2
    assert hdr[:, 4 + 3 * cumlk].sum() == n[4]
    K = stark_kernels.aes_n_constraints(n)
    assert hdr[:, 2].min() >= 0 and (hdr[:, 2] + hdr[:, 3]).max() == K
    gathers = stark_kernels.aes_item_gathers()
    per_slice = sum(hdr[:, 4 + 3 * k] * gathers[name] for k, name in enumerate(kinds))
    assert per_slice.max() <= stark_kernels.AES_SLICE_GATHERS
    s = int(np.argmax(hdr[:, 4 + 3 * kinds.index("lookup")] > 0))
    h = hdr[s]
    k = kinds.index("lookup")
    cnt, rb = h[4 + 3 * k], h[5 + 3 * k]
    lk0 = max(bounds[s], sum(n[:4])) - sum(n[:4])    # its first lookup
    F0 = idx[off[4] + 16 * n[4] + lk0]
    assert srows[h[0] + rb + 16 * cnt] == F0


@pytest.fixture
def h_emu(emulated, monkeypatch):
    """h_kernels' launch paths, pointed at the emulated library."""
    monkeypatch.setattr(h_kernels, "_lib", lambda: emulated[3])
    monkeypatch.setattr(h_kernels, "_stream", lambda t: None)
    monkeypatch.setattr(h_kernels, "_require_cuda", lambda t, what: None)
    return h_kernels


def _fr_limbs(rng, shape, mont=True):
    """Canonical Fr elements [16, *shape] from a numpy generator, with 0, 1
    and r - 1 among the first."""
    count = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") % Fr.p
            for _ in range(count)]
    vals[:3] = [0, 1, Fr.p - 1][:count]
    return Fr.to_device(vals, mont=mont).reshape(Fr.L, *shape)


def test_k0_emulated(h_emu):
    """K0 at N = 231 elements (a ragged last block of 128 threads): to_mont
    equal to Fr.to_mont, the quotient (a b - c) / Z over [16, 3, 2, 70]
    equal to quotient_plain; one launch each."""
    rng = np.random.default_rng(17)
    x = _fr_limbs(rng, (3, 77), mont=False)
    before = h_emu.LAUNCHES["fr_elementwise"]
    assert torch.equal(h_emu._launch_to_mont(x), Fr.to_mont(x))
    abc = _fr_limbs(rng, (3, 2, 70))
    zinv = int.from_bytes(rng.bytes(32), "little") % Fr.p
    assert torch.equal(h_emu._launch_quotient(abc, zinv),
                       h_emu.quotient_plain(abc, zinv))
    assert h_emu.LAUNCHES["fr_elementwise"] == before + 2


def test_k5_emulated(h_emu):
    """K5 over three stacked matrices of 200 rows (empty rows, a row of 300
    terms, repeated columns; random, so wide, coefficients) at k = 2
    proofs: the short bin's (row, proof) threads with a ragged last block,
    the warp bin's 300-term rows; equal to sparse_matvec_plain, one
    launch."""
    rng = np.random.default_rng(5)
    n, m_pad, k = 200, 40, 2
    mats = []
    for m in range(3):
        counts = rng.integers(0, 4, n)
        counts[rng.integers(0, n, 20)] = 0
        counts[7 + m] = 300
        rows = np.repeat(np.arange(n), counts)
        cols = rng.integers(0, m_pad, rows.size)
        mats.append((torch.from_numpy(rows), torch.from_numpy(cols),
                     _fr_limbs(rng, (rows.size,))))
    csr = h_kernels.CSR.stack(mats, n)
    z = h_kernels.pack_z(_fr_limbs(rng, (k, m_pad)))
    before = h_emu.LAUNCHES["sparse_matvec"]
    got = h_emu._launch_sparse_matvec(z, csr)
    assert got.shape == (Fr.L, 3, k, n)
    assert torch.equal(got, h_kernels.sparse_matvec_plain(z, csr))
    assert h_emu.LAUNCHES["sparse_matvec"] == before + 1


# (dif, dit, scale) of each NTTContext transform
NTT_FORMS = {"dif_inverse": (True, False, "ninv"),
             "dit_forward": (False, True, None),
             "coset_evals_from_coeffs_br": (False, True, "shift"),
             "coeffs_br_from_coset_evals": (True, False, "ninv_shift_inv"),
             "coeffs_br_from_coset_evals from_mont": (
                 True, False, "ninv_shift_inv_plain"),
             "coset_evals_from_evals": (True, True, "ninv_shift")}


@pytest.mark.parametrize("log_n", [8, 9, 10])
def test_k4_emulated(h_emu, log_n):
    """K4 with a tile of 2^4 elements: 2^8 in two stage groups, 2^9 and
    2^10 in three (the top one of 1 and 2 stages, 8 and 4 consecutive low
    indices a tile); every transform's form (DIF, DIT, both in one chunk
    launch; the table by position, a constant, none) over two rows equal
    to NTTContext's plain version, in the number of launches ntt_plan
    says; at 2^10 also the default tile (one launch a direction)."""
    ctx = NTTContext(Fr, 1 << log_n, device="cpu")
    tw_inv, tw_fwd, words = ctx._kernel_tables()
    x = _fr_limbs(np.random.default_rng(log_n), (2, 1 << log_n))
    groups = len(h_kernels.ntt_plan(log_n, 4))
    assert groups == (2 if log_n == 8 else 3)
    for name, (dif, dit, scale) in NTT_FORMS.items():
        before = h_emu.LAUNCHES["ntt_group"]
        got = h_emu.ntt(x, tw_inv, tw_fwd, dif, dit,
                        None if scale is None else words[scale], log_tile=4)
        assert h_emu.LAUNCHES["ntt_group"] - before == \
            (2 * groups - 1 if dif and dit else groups), name
        assert torch.equal(got, ctx._transform_plain(x, dif, dit, scale)), name
    if log_n == 10:
        got = h_emu.ntt(x, tw_inv, tw_fwd, True, True, words["ninv_shift"])
        assert torch.equal(got, ctx._transform_plain(x, True, True,
                                                     "ninv_shift"))


# coefficients of every K5 class and its edges (test_torch_h_kernels.py's)
K5_EDGES = [1, Fr.p - 1, 0, 7, Fr.p - 7, (1 << 32) - 1, Fr.p - ((1 << 32) - 1),
            1 << 32, Fr.p - (1 << 32), 1 << 40, Fr.p - (1 << 40)]


@pytest.mark.parametrize("k", [1, 3])
def test_k5_bins_emulated(h_emu, k):
    """K5's three bins and every coefficient class in one launch, at k = 1
    and 3: rows of 0-16 terms (a thread's), 17 (just over SHORT_ROW) and 40
    (a warp's), 1,025 (just over WARP_ROW: a block's), a short and a warp
    row whose terms are all -1, coefficients cycling through +-1, 0, +-7,
    +-(2^32 - 1), +-2^32, +-2^40 and random ones, z with 0, 1 and r - 1;
    equal to sparse_matvec_plain limb for limb."""
    rng = np.random.default_rng(31 + k)
    n, m_pad = 24, 50
    S, W = h_kernels.SHORT_ROW, h_kernels.WARP_ROW
    mats = []
    for m in range(3):
        counts = rng.integers(0, S + 1, n)
        counts[[2, 5, 9, 11, 13]] = [0, S + 1, 40, W + 1 if m == 1 else 3, 5]
        counts[20 + m] = 20                     # all -1, a warp's
        rows = np.repeat(np.arange(n), counts)
        vals = [K5_EDGES[t % len(K5_EDGES)] for t in range(rows.size)]
        for t in range(0, rows.size, 7):
            vals[t] = int.from_bytes(rng.bytes(32), "little") % Fr.p
        for r in (13, 20 + m):
            at = int(counts[:r].sum())
            vals[at:at + int(counts[r])] = [Fr.p - 1] * int(counts[r])
        mats.append((torch.from_numpy(rows),
                     torch.from_numpy(rng.integers(0, m_pad, rows.size)),
                     Fr.to_device(vals)))
    csr = h_kernels.CSR.stack(mats, n)
    assert all(b > 0 for b in csr.bins)
    z = h_kernels.pack_z(_fr_limbs(rng, (k, m_pad)))
    before = h_emu.LAUNCHES["sparse_matvec"]
    got = h_emu._launch_sparse_matvec(z, csr)
    assert got.shape == (Fr.L, 3, k, n)
    assert torch.equal(got, h_kernels.sparse_matvec_plain(z, csr))
    assert h_emu.LAUNCHES["sparse_matvec"] == before + 1


@pytest.mark.parametrize("dif", [True, False], ids=["DIF", "DIT"])
def test_k0_cross_stage_emulated(h_emu, dif):
    """K0's two cross-stage modes, both halves, over [16, 3, 77] blocks (a
    ragged last block of 128 threads; the twiddle of element i at (t0 + i)
    stride of a 2^9-point table, the same for the three rows), and its pack
    mode over [16, 2, 77]: equal to cross_stage_plain / pack_z_plain."""
    rng = np.random.default_rng(41 + dif)
    ctx = NTTContext(Fr, 1 << 9, device="cpu")
    tw_inv, tw_fwd, _ = ctx._kernel_tables()
    x, other = _fr_limbs(rng, (3, 77)), _fr_limbs(rng, (3, 77))
    for v_half, t0, stride in ((False, 0, 2), (True, 50, 2), (True, 3, 3)):
        tw = tw_inv if dif else tw_fwd
        args = (x, other, tw, t0, stride, dif, v_half)
        assert torch.equal(h_emu.cross_stage(*args),
                           h_kernels.cross_stage_plain(*args))
    z = _fr_limbs(rng, (2, 77))
    assert torch.equal(h_emu.pack_z(z), h_kernels.pack_z_plain(z))


@pytest.fixture
def h_card(h_emu, monkeypatch):
    """Every H wrapper taking its kernel, emulated, on CPU tensors."""
    monkeypatch.setattr(h_kernels, "_on_card", lambda t: True)
    return h_kernels


@pytest.mark.parametrize("log_n", [8, 10])
def test_k4_plan_by_grid_emulated(h_card, log_n):
    """K4 in the tile ntt_plan picks from the grid (two launches a
    direction) over one and three rows of 2^8 and 2^10: every transform
    form equal to NTTContext's plain version."""
    ctx = NTTContext(Fr, 1 << log_n, device="cpu")
    for rows in (1, 3):
        x = _fr_limbs(np.random.default_rng(log_n + rows), (rows, 1 << log_n))
        assert len(h_kernels.ntt_plan(log_n, rows=rows)) == 2
        for name, (dif, dit, scale) in NTT_FORMS.items():
            before = h_card.LAUNCHES["ntt_group"]
            got = ctx._transform(x, dif, dit, scale)
            assert h_card.LAUNCHES["ntt_group"] - before == \
                (3 if dif and dit else 2), name
            assert torch.equal(got, ctx._transform_plain(x, dif, dit, scale)), name


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_h_emulated(h_card, monkeypatch, D):
    """ProverContext's sharded H on a mesh of D shards (the CPU's, every
    wrapper taking its emulated kernel): the row slices through K5, the
    exchanged stages through K0's cross-stage modes, each block's local
    stages through K4 over the C-point tables, the quotient through K0;
    equal to the one-device plain H limb for limb, and launching each."""
    from zksc_tpu_torch.groth16.prove import ProverContext
    from zksc_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(50 + D)
    n, m_pad = 64, 30
    mats = []
    for _ in range(3):
        counts = rng.integers(0, 4, n)
        counts[7] = 25
        rows = np.repeat(np.arange(n), counts)
        vals = [K5_EDGES[t % len(K5_EDGES)] for t in range(rows.size)]
        mats.append((torch.from_numpy(rows),
                     torch.from_numpy(rng.integers(0, m_pad, rows.size)),
                     Fr.to_device(vals)))
    ntt = NTTContext(Fr, n, device="cpu")
    stub = types.SimpleNamespace(ntt=ntt, _mats=mats,
                                 _csr=h_kernels.CSR.stack(mats, n),
                                 _zinv=pow(ntt.z_coset_int, -1, Fr.p),
                                 device=torch.device("cpu"))
    z = _fr_limbs(rng, (1, m_pad))
    monkeypatch.setattr(h_kernels, "_on_card", lambda t: False)
    want = ProverContext._h_pipeline_batch(stub, z)[:, 0]
    monkeypatch.setattr(h_kernels, "_on_card", lambda t: True)
    h_sharded = ProverContext._build_sharded_h(stub, make_mesh(D, ["cpu"]))
    h_card.reset_launch_counts()
    assert torch.equal(h_sharded(z[:, 0]), want)
    assert all(v > 0 for v in h_card.LAUNCHES.values()), h_card.LAUNCHES


# ---------------------------------------------------------------- K6

@pytest.fixture
def glue_emu(kernels, emulated, monkeypatch):
    """msm_glue's launch paths (and ec_kernels', for K1 / K2), pointed at
    the emulated libraries."""
    monkeypatch.setattr(msm_glue, "_lib", lambda: emulated[4])
    monkeypatch.setattr(msm_glue, "_stream", lambda t: None)
    monkeypatch.setattr(msm_glue, "_require_cuda", lambda t, what: None)
    return msm_glue


def _glue_scalars(rng, k: int, n: int, n_bits: int):
    """[16, k, n] plain limbs: runs of 0 / 1 (a witness's bits) and
    full-width values below 2^n_bits."""
    rows = []
    for _ in range(k):
        vals = [int(v) for v in rng.integers(0, 2, n)]
        for i in rng.choice(n, n // 3, replace=False):
            vals[i] = int.from_bytes(rng.bytes(32), "little") % (1 << n_bits)
        run = min(40, n // 4)
        vals[n // 2:n // 2 + run] = [1] * run
        rows.append(Fr.to_device(vals, mont=False))
    return torch.stack(rows, dim=1)


@pytest.mark.parametrize("c, n", [(4, 300), (13, 4096 + 37), (14, 300)])
def test_k6a_emulated(glue_emu, c, n):
    """K6a's keys and histogram equal keys_plain's over 254-bit scalars of
    two proofs: c = 13 through the shared-memory histogram over two blocks
    of lanes (the last ragged), c = 4 (64 windows) and c = 14 (global
    atomics); and on a strided view of the limbs, as a prover's private
    slice of the witness."""
    rng = np.random.default_rng(60 + c)
    W = -(-254 // c)
    sp = _glue_scalars(rng, 2, n + 9, 254)
    for s in (sp[:, :, :n].contiguous(), sp[:, :, 9:]):
        got = glue_emu._launch_keys(s, c, W)
        want = msm_glue.keys_plain(s, c, W)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(want[1].sum()) == 2 * W * n


def _glue_lanes(points, g2, T, seed):
    """T lanes of crafted pairs (chip_smoke.craft: identity, P = Q, P = -Q,
    affine and Jacobian mixed) interleaved, so pair members are adjacent
    lanes."""
    fops = _fops(g2)
    A, B = _pair(points, g2, 448, seed)
    idx = torch.arange(T) % 896
    src = lambda i: torch.where(i % 2 == 0, i // 2, 448 + i // 2)
    both = msm_glue._cat(fops, [A, B])
    return msm_glue._take(fops, both, src(idx)), fops


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_k6b_emulated(glue_emu, points, g2):
    """K6b equals sorted_gather_plain over a permutation of 3 segments of
    64 points, in K1's step-major layout (C0 = 12) and in position order."""
    fops = _fops(g2)
    P, _ = _glue_lanes(points, g2, 64, seed=61)
    sidx = torch.from_numpy(np.random.default_rng(62).permutation(192))
    for C0 in (12, None):
        _equal(glue_emu._launch_sorted_gather(fops, P, sidx, 64, C0),
               msm_glue.sorted_gather_plain(fops, P, sidx, 64, C0))


@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_k6c_emulated(glue_emu, points, monkeypatch, g2, inclusive):
    """K6c equals scan_top_plain on crafted adjacent pairs: one tile of 5
    lanes and three tiles of 300 lanes (two launches, a ragged last tile),
    then runs of 3 lanes (scan_plan forced; the plain version follows the
    same plan) over one tile and over several."""
    fops = _fops(g2)
    P_ = msm_glue.SCAN_THREADS // (2 if g2 else 1)
    for T in (5, 300):
        X, _ = _glue_lanes(points, g2, T, seed=63 + T)
        _equal(glue_emu._launch_scan_top(fops, X, inclusive),
               msm_glue.scan_top_plain(fops, X, inclusive))
    monkeypatch.setattr(msm_glue, "scan_plan", lambda T, g: (
        P_, 3, -(-(-(-T // 3)) // P_)))
    for T in (100, 3 * P_ + 7, 7 * P_ + 2):
        X, _ = _glue_lanes(points, g2, T, seed=64 + T)
        _equal(glue_emu._launch_scan_top(fops, X, inclusive),
               msm_glue.scan_top_plain(fops, X, inclusive))


def _window_sums_inputs(points, g2, seed):
    """32 points (an identity lane, a duplicated point) and 40-bit scalars
    of two proofs."""
    g1a, _, g2h = points
    P = chip_smoke.g2_lanes(g2h, 0, 32) if g2 else chip_smoke.g1_lanes(g1a, 0, 32)
    P = ec.JacPoint(*(a.clone() for a in P))
    for half in ((0, 32) if g2 else (0,)):
        for a in P:
            a[:, half + 5] = a[:, half + 4]
        P.z[:, half + 9] = 0
    sp = _glue_scalars(np.random.default_rng(seed), 2, 32, 40)
    return P, sp


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_k6d_emulated(glue_emu, points, monkeypatch, g2):
    """K6d equals bucket_boundaries_plain on the levels of a 40-bit MSM of
    two proofs over 32 points at c = 5 (16 segments, N = 512) with _HS_MAX
    lowered to 1: level 0, an exclusive K1 level and the top."""
    fops = _fops(g2)
    P, sp = _window_sums_inputs(points, g2, seed=65 + g2)
    seen = []
    orig = msm_glue.bucket_boundaries

    def rec(*args):
        seen.append(args)
        return orig(*args)
    monkeypatch.setattr(msm, "_HS_MAX", 1)
    monkeypatch.setattr(msm_glue, "bucket_boundaries", rec)
    msm._window_sums(fops, P, sp, 5, 8)
    args = seen[0]
    assert len(args[1]) == 3 and args[2].shape == (16, 32)
    _equal(glue_emu._launch_bucket_boundaries(*args),
           msm_glue.bucket_boundaries_plain(*args))


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_window_sums_emulated(glue_emu, points, monkeypatch, g2):
    """A whole _window_sums (c = 5, _HS_MAX lowered to 1) with every
    kernel wrapper taking its emulated kernel: K6a, K6b, K1 twice, K6c,
    K6d and the halving reduce's K2, equal to the plain run limb for
    limb."""
    fops = _fops(g2)
    P, sp = _window_sums_inputs(points, g2, seed=67 + g2)
    monkeypatch.setattr(msm, "_HS_MAX", 1)
    want = msm._window_sums(fops, P, sp, 5, 8)
    for name in ("keys", "sorted_gather", "scan_top", "bucket_boundaries"):
        monkeypatch.setattr(msm_glue, name, getattr(msm_glue, "_launch_" + name))
    monkeypatch.setattr(ec_kernels, "chunk_scan", ec_kernels._launch_chunk_scan)
    monkeypatch.setattr(ec_kernels, "jac_add_n", ec_kernels._launch_jac_add_n)
    glue_emu.reset_launch_counts()
    _equal(msm._window_sums(fops, P, sp, 5, 8), want)
    assert glue_emu.LAUNCHES == {"msm_keys": 1, "sorted_gather": 2,
                                 "scan_top": 1, "bucket_boundaries": 2}


@pytest.mark.parametrize("name, constant", [("SCAN_STEPS", "kScanSteps"),
                                            ("SCAN_THREADS", "kGlueThreads"),
                                            ("MAX_LEVELS", "kMaxLevels")])
def test_k6_constants_match_source(name, constant):
    """msm_glue's copies of K6's constants are the kernels' own, and the
    step-major width is K1's chunk width in ops/msm.py."""
    src = open(os.path.join(CSRC, "msm_glue.cu")).read()
    m = re.search(rf"constexpr int {constant} = (\d+);", src)
    assert m and int(m.group(1)) == getattr(msm_glue, name)
    assert msm_glue.SCAN_STEPS == msm._SCAN_S

"""Wrappers of the hand-written CUDA kernels of the Circle-STARK engine.

  - blake2s (K7a): Blake2s-256 of many messages from a strided source;
    replaces the work of zksc_tpu/stark/blake2s.py:blake2s / blake2s_pair.
    blake2s_tree (K7a's tree launch): a whole Merkle tree over strided
    leaves, every layer, in one launch (zksc_tpu/stark/merkle.py:commit).
  - circle_fft (K7b): a whole circle FFT (interpolate or evaluate) over a
    batch of columns in one launch, each column held in shared memory, for
    N <= 2^FFT_MAX_LOG; circle_layer (K7b above that): one fold layer a
    launch. Both replace zksc_tpu/stark/circle.py:CircleFFT.interpolate /
    evaluate, which XLA fuses.
  - composition (K7c): the constraint composition divided by V_N; replaces
    zksc_tpu/stark/prover.py:_composition.
  - aes_composition (K7d): the same for the AES-CTR LogUp AIR, with the
    sigma-shifted rows read in place; replaces
    zksc_tpu/stark/aes_prover.py:_composition.

Source: ``csrc/stark_kernels.cu`` (with ``csrc/m31.cuh``), compiled for
sm_90a by one plain ``nvcc`` call into ``build/libzksc_stark.so`` at first
use (ops/cuda_build.py) and loaded with ctypes.

These functions launch on CUDA tensors only (on the current stream, without
synchronising) and raise on anything else; the callers in ``stark/`` send a
CPU tensor to the plain PyTorch versions beside them (``blake2s.py``,
``circle.py``, ``prover.py``, ``aes_prover.py``). ``LAUNCHES`` counts real kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build

LAUNCHES = {"blake2s": 0, "circle_layer": 0, "composition": 0,
            "aes_composition": 0}

# K7b: transforms of up to 2^FFT_MAX_LOG values are one circle_fft launch
# (the column in shared memory; the kernel's kFftMaxLog); longer ones run
# circle_layer, one launch a layer
FFT_MAX_LOG = 15
# constraints per K7c slice (at most the kernel's kSliceMax, 128), and the
# smaller slice for a single 32-thread point tile
COMPOSITION_SLICE = 64
COMPOSITION_SLICE_SMALL = 32
# K7c gathers with 64-bit offsets from R * M values on
WIDE_OFFSETS_FROM = 1 << 31
# values gathered per K7d slice (aes_slices): ~120 slices for the AES-128
# AIR (~30.5k values a point)
AES_SLICE_GATHERS = 256
# K7d's grid order: from this many point tiles on, consecutive blocks take
# the slices of one point tile, so the rows a tile's slices share stay in
# L2; below it, the point tiles of one slice (the faster order on one
# H100 at M = 4,096-8,192 and at 2,048 respectively)
AES_SLICES_FIRST_TILES = 8


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib):
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lls = ctypes.POINTER(ctypes.c_longlong)
    lib.zksc_blake2s.restype = ci
    lib.zksc_blake2s.argtypes = [vp, cll, cll, cll, cll, vp, vp]
    lib.zksc_blake2s_tree.restype = ci
    lib.zksc_blake2s_tree.argtypes = [vp, cll, cll, cll, cll, vp, vp, vp]
    lib.zksc_circle_layer.restype = ci
    lib.zksc_circle_layer.argtypes = [vp, vp, cll, ci, ci, ci, ci, vp, vp]
    lib.zksc_circle_fft.restype = ci
    lib.zksc_circle_fft.argtypes = [vp, vp, cll, ci, ci, ci, vp, vp]
    lib.zksc_composition.restype = ci
    lib.zksc_composition.argtypes = [vp, cll, vp, lls, lls, vp, cll, ci, ci,
                                     ci, vp, vp, vp, vp]
    lib.zksc_aes_composition.restype = ci
    lib.zksc_aes_composition.argtypes = [
        vp, cll, vp, ctypes.POINTER(ctypes.c_uint), vp, vp, cll, vp, ci, ci,
        ci, ci, vp, vp, vp, vp]


def _lib():
    return cuda_build.load("stark", _declare)


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(t: torch.Tensor, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")


def _check(t: torch.Tensor, what: str, shape=None):
    _require_cuda(t, what)
    if t.dtype != torch.int32:
        raise ValueError(f"{what}: expected int32, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


# ---------------------------------------------------------------- K7a

def n_words(length: int) -> int:
    return (length + 3) // 4


def check_strided(base: torch.Tensor, count: int, length: int,
                  msg_stride: int, word_stride: int, what: str):
    """Raise unless every word the strided read touches lies in `base`
    (int32, contiguous from its first element)."""
    if count < 0 or length < 0 or msg_stride < 0 or word_stride < 0:
        raise ValueError(f"{what}: negative count, length or stride")
    if count == 0 or length == 0:
        return
    last = (count - 1) * msg_stride + (n_words(length) - 1) * word_stride
    if last >= base.numel():
        raise ValueError(f"{what}: the strided read reaches word {last} of a "
                         f"source of {base.numel()} words")


def blake2s(base: torch.Tensor, count: int, length: int, msg_stride: int,
            word_stride: int) -> torch.Tensor:
    """K7a: Blake2s-256 of `count` messages of `length` bytes; word j of
    message i is base.view(-1)[i * msg_stride + j * word_stride] (bytes
    little-endian, those past `length` ignored). Returns int32 [count, 8],
    the digests' words (``.view(torch.uint8)`` gives the bytes)."""
    _check(base, "blake2s source")
    check_strided(base, count, length, msg_stride, word_stride, "blake2s")
    out = torch.empty((count, 8), dtype=torch.int32, device=base.device)
    if count == 0:
        return out
    rc = _lib().zksc_blake2s(base.data_ptr(), count, length, msg_stride,
                             word_stride, out.data_ptr(), _stream(base))
    _raise_on(rc, "blake2s")
    LAUNCHES["blake2s"] += 1
    return out


_TICKETS = {}


def _ticket(t: torch.Tensor) -> torch.Tensor:
    """The tree launch's ticket for t's device and current stream: one
    int32 that zksc_blake2s_tree zeroes on the stream before each launch,
    so launches on one stream share it."""
    key = (t.device, _stream(t))
    tk = _TICKETS.get(key)
    if tk is None:
        tk = _TICKETS[key] = torch.empty(1, dtype=torch.int32, device=t.device)
    return tk


def blake2s_tree(base: torch.Tensor, count: int, length: int, msg_stride: int,
                 word_stride: int) -> torch.Tensor:
    """K7a's tree launch: the Merkle tree over `count` (a power of two)
    leaves, leaf i the Blake2s-256 of the strided message i (as
    ``blake2s``), each node the hash of its children's digests. Returns
    int32 [2 * count - 1, 8]: the leaf digests, then each node layer up to
    the root, back to back. One launch."""
    _check(base, "blake2s_tree source")
    if count < 1 or count & (count - 1):
        raise ValueError(f"blake2s_tree: {count} leaves is not a power of two")
    check_strided(base, count, length, msg_stride, word_stride, "blake2s_tree")
    out = torch.empty((2 * count - 1, 8), dtype=torch.int32, device=base.device)
    rc = _lib().zksc_blake2s_tree(base.data_ptr(), count, length, msg_stride,
                                  word_stride, out.data_ptr(),
                                  _ticket(base).data_ptr(), _stream(base))
    _raise_on(rc, "blake2s_tree")
    LAUNCHES["blake2s"] += 1
    return out


# ---------------------------------------------------------------- K7b

def circle_layer(src: torch.Tensor, interp: bool, rev: bool, log_w: int,
                 tw: torch.Tensor) -> torch.Tensor:
    """K7b: one fold layer over the rows of src [C, N] (csrc/stark_kernels.cu
    circle_layer_kernel): interpolate's y-fold (interp, not rev) or an
    x-fold (interp, rev), evaluate's x-layer (rev) or y-layer (not rev), at
    chunk width 2^log_w with 2^log_w twiddles. Returns a new [C, N]."""
    _check(src, "circle_layer input")
    if src.dim() != 2:
        raise ValueError(f"circle_layer: expected [C, N], got {tuple(src.shape)}")
    C, N = src.shape
    log_n = N.bit_length() - 1
    if N < 2 or N != 1 << log_n or not 0 <= log_w <= log_n - 1:
        raise ValueError(f"circle_layer: N={N}, log_w={log_w}")
    _check(tw, "circle_layer twiddles", shape=(1 << log_w,))
    if tw.device != src.device:
        raise ValueError("circle_layer: twiddles on another device")
    out = torch.empty_like(src)
    if C == 0:
        return out
    rc = _lib().zksc_circle_layer(src.data_ptr(), out.data_ptr(), C, log_n,
                                  int(interp), int(rev), log_w, tw.data_ptr(),
                                  _stream(src))
    _raise_on(rc, "circle_layer")
    LAUNCHES["circle_layer"] += 1
    return out


def circle_fft(src: torch.Tensor, interp: bool, log_n: int,
               tw: torch.Tensor) -> torch.Tensor:
    """K7b's one-launch transform (csrc/stark_kernels.cu circle_fft_kernel):
    a whole CircleFFT.interpolate (interp; src [C, N]) or evaluate (src
    [C, K], K <= N coefficients a column, the rest taken as zeros) of N =
    2^log_n, 2 <= log_n <= FFT_MAX_LOG, each column held in shared memory.
    tw: the packed twiddles [N] (CircleFFT.twiddles' "fft_interp" /
    "fft_eval"). Returns a new [C, N].
    Counted under K7b's key, circle_layer."""
    _check(src, "circle_fft input")
    if src.dim() != 2:
        raise ValueError(f"circle_fft: expected [C, K], got {tuple(src.shape)}")
    C, K = src.shape
    N = 1 << log_n
    if not 2 <= log_n <= FFT_MAX_LOG or K > N or (interp and K != N):
        raise ValueError(f"circle_fft: log_n={log_n}, K={K}, interp={interp}")
    _check(tw, "circle_fft twiddles", shape=(N,))
    if tw.device != src.device:
        raise ValueError("circle_fft: twiddles on another device")
    out = torch.empty((C, N), dtype=torch.int32, device=src.device)
    if C == 0:
        return out
    rc = _lib().zksc_circle_fft(src.data_ptr(), out.data_ptr(), C, log_n, K,
                                int(interp), tw.data_ptr(),
                                _stream(src))
    _raise_on(rc, "circle_fft")
    LAUNCHES["circle_layer"] += 1
    return out


# ---------------------------------------------------------------- K7c

GROUP_FIELDS = (("bool", (None,)),
                ("add", ("A", "B", "R", "C", "Cin")),
                ("addx", ("U", "W", "B", "R", "C", "Cin")),
                ("xor", ("A", "B", "R")),
                ("eq", ("KS", "PT", "CT")))


def pack_groups(groups: dict) -> tuple:
    """The AIR's index groups (chacha_air.layout()) -> (idx int32 numpy
    array, off, n): group g's field f of constraint i at idx[off[g] + f *
    n[g] + i], in K7c's order bool, add, addx, xor, eq."""
    parts, off, n, at = [], [], [], 0
    for name, fields in GROUP_FIELDS:
        g = groups[name]
        cols = [g] if fields == (None,) else [g[f] for f in fields]
        off.append(at)
        n.append(len(cols[0]))
        for c in cols:
            parts.append(np.asarray(c, dtype=np.int32))
            at += len(c)
    return np.concatenate(parts), tuple(off), tuple(n)


def composition_plan(M: int) -> tuple:
    """K7c's launch shape at M points: (constraints a slice, points a
    thread, threads a block), the fastest of the shapes timed on one H100.
    Four neighbouring points a thread (16-byte
    gathers) from M = 512, two from 64, else one; 128-thread point tiles
    where they fill, else one warp; slices of 64 constraints, 32 for a
    single warp tile (M = 32: ~1,700 one-warp blocks on the
    54,784-constraint stwo AIR)."""
    points = 4 if M % 4 == 0 and M >= 512 else 2 if M % 2 == 0 and M >= 64 else 1
    threads = 128 if M // points >= 128 else 32
    tiles = -(-M // (points * threads))
    slice_ = COMPOSITION_SLICE if tiles * threads >= 128 else COMPOSITION_SLICE_SMALL
    return slice_, points, threads


def composition(vals: torch.Tensor, idx: torch.Tensor, off: tuple, n: tuple,
                weights: torch.Tensor, vn_inv: torch.Tensor) -> torch.Tensor:
    """K7c: Q = (sum_k w_k c_k) / V_N as int32 [4, M] from vals [R, M], the
    packed index groups (pack_groups, on the device), weights [K, 4] and
    vn_inv [M], in the launch shape composition_plan(M). Two launches: the
    sliced sums, then their total."""
    _check(vals, "composition vals")
    if vals.dim() != 2:
        raise ValueError(f"composition: expected vals [R, M], got {tuple(vals.shape)}")
    R, M = vals.shape
    K = sum(n)
    _check(idx, "composition idx", shape=(off[-1] + 3 * n[-1],))
    _check(weights, "composition weights", shape=(K, 4))
    _check(vn_inv, "composition vn_inv", shape=(M,))
    for t in (idx, weights, vn_inv):
        if t.device != vals.device:
            raise ValueError("composition: operands on different devices")
    if len(off) != 5 or len(n) != 5:
        raise ValueError("composition: expected five index groups")
    slice_, points, threads = composition_plan(M)
    n_slices = max(1, -(-K // slice_))
    if n_slices > 65535:
        raise ValueError(f"composition: {n_slices} slices exceed the grid")
    if vals.data_ptr() % (4 * points):
        raise ValueError(f"composition: vals is not {4 * points}-byte aligned")
    if weights.data_ptr() % 16:
        raise ValueError("composition: weights are not 16-byte aligned")
    partial = torch.empty((n_slices, 4, M), dtype=torch.int32, device=vals.device)
    out = torch.empty((4, M), dtype=torch.int32, device=vals.device)
    if M == 0:
        return out
    c_off = (ctypes.c_longlong * 5)(*off)
    c_n = (ctypes.c_longlong * 5)(*n)
    rc = _lib().zksc_composition(vals.data_ptr(), M, idx.data_ptr(), c_off,
                                 c_n, weights.data_ptr(), slice_, points,
                                 threads, int(R * M >= WIDE_OFFSETS_FROM),
                                 partial.data_ptr(), vn_inv.data_ptr(),
                                 out.data_ptr(), _stream(vals))
    _raise_on(rc, "composition")
    LAUNCHES["composition"] += 2    # composition_kernel, composition_finish_kernel
    return out


# ---------------------------------------------------------------- K7d

AES_GROUP_FIELDS = (
    ("bool", (None,)),
    ("const", (None,)),
    ("xor", (("A", None), ("B", None), ("R", None))),
    ("mix", tuple(("T", f) for f in range(9)) + (("R", None), ("K0", None),
                                                 ("K1", None), ("K2", None))),
    ("lookup", tuple(("U", f) for f in range(8)) + tuple(("V", f) for f in range(8))
     + tuple(("F", f) for f in range(4))),
    ("eq", (("KS", None), ("PT", None), ("CT", None))))


def pack_aes_groups(groups: dict) -> tuple:
    """The AES AIR's index groups (aes_air.layout(key_size)[2]) -> (idx
    int32 numpy array, off, n, rows): group g's field f of item i at
    idx[off[g] + f * n[g] + i], groups bool, const, xor, mix, lookup, eq
    (K7d's AesAir); rows = (M, TVAL, SVAL, TACT, G[0..3], cum[0..3])."""
    parts, off, n, at = [], [], [], 0
    for name, fields in AES_GROUP_FIELDS:
        g = groups[name]
        if fields == (None,):
            cols = [np.asarray(g)]
        else:
            cols = [np.asarray(g[k]) if c is None else np.asarray(g[k])[:, c]
                    for k, c in fields]
        off.append(at)
        n.append(len(cols[0]))
        for c in cols:
            parts.append(c.astype(np.int32))
            at += len(c)
    tb = groups["table"]
    rows = (int(tb["M"]), int(tb["TVAL"]), int(tb["SVAL"]), int(tb["TACT"]),
            *(int(r) for r in tb["G"]), *(int(r) for r in groups["cum"]))
    return np.concatenate(parts), tuple(off), tuple(n), rows


def aes_n_constraints(n: tuple) -> int:
    """Weight rows of the AES AIR from pack_aes_groups' n: four a lookup
    instance, four each for the table and cum."""
    return n[0] + n[1] + n[2] + n[3] + 4 * n[4] + 8 + n[5]


# K7d's item kinds, in the order of its items and of the alpha powers. The
# cum column's constraint is linear in its parts, so it is cut into the cum
# item (cum at x and sigma x, G at sigma x) and one cumlk item a lookup
# instance (its four F columns at sigma x, subtracted): aes_slices spreads
# the 4 n_lk gathers of its sum over slices like any other item's.
AES_KINDS = ("bool", "const", "xor", "mix", "lookup", "table", "cum", "cumlk",
             "eq")
# ints of a K7d slice header (the kernel's kAesHdr), and the rows and weight
# rows a slice may stage (kAesRowsMax, kAesWeightsMax)
AES_HDR = 32
AES_ROWS_MAX = 512
AES_WEIGHTS_MAX = 512


def aes_item_counts(n: tuple) -> dict:
    """Items of each kind from pack_aes_groups' n (one table, one cum, a
    cumlk a lookup instance)."""
    return dict(zip(AES_KINDS, (n[0], n[1], n[2], n[3], n[4], 1, 1, n[4], n[5])))


def aes_item_gathers() -> dict:
    """Values K7d gathers from vals for one item of each kind: const reads
    its row at x and sigma(x); the table reads TVAL, SVAL, G (4), M and
    TACT; cum reads cum at x and sigma(x) and G at sigma(x); cumlk a
    lookup's four F columns at sigma(x)."""
    return {"bool": 1, "const": 2, "xor": 3, "mix": 13, "lookup": 20,
            "table": 8, "cum": 12, "cumlk": 4, "eq": 3}


def aes_slices(n: tuple) -> np.ndarray:
    """K7d's slice bounds over its items (AES_KINDS order) as int64
    [n_slices + 1]: consecutive items, a new slice where the values gathered
    would pass AES_SLICE_GATHERS."""
    counts, gathers = aes_item_counts(n), aes_item_gathers()
    costs = np.concatenate([np.full(counts[k], gathers[k]) for k in AES_KINDS])
    bounds, acc = [0], 0
    for i, c in enumerate(costs):
        if acc and acc + c > AES_SLICE_GATHERS:
            bounds.append(i)
            acc = 0
        acc += c
    bounds.append(len(costs))
    return np.asarray(bounds, dtype=np.int64)


def _aes_kind_rows(idx: np.ndarray, off: tuple, n: tuple, rows: tuple) -> list:
    """Each kind's item fields as [fields, items] int32 arrays (AES_KINDS
    order): the kernel's field order (table: TVAL, SVAL, G0-3, M, TACT;
    cum: cum0-3, G0-3; cumlk: the lookups' F0-3)."""
    def group(g, fields):
        return idx[off[g]:off[g] + fields * n[g]].reshape(fields, n[g])
    lookup = group(4, 20)
    table = np.asarray([rows[1], rows[2], *rows[4:8], rows[0], rows[3]],
                       dtype=np.int32)[:, None]
    cum = np.asarray([*rows[8:12], *rows[4:8]], dtype=np.int32)[:, None]
    return [group(0, 1), group(1, 1), group(2, 3), group(3, 13), lookup, table,
            cum, lookup[16:20], group(5, 3)]


def aes_slice_table(idx: np.ndarray, off: tuple, n: tuple, rows: tuple,
                    bounds: np.ndarray) -> tuple:
    """K7d's staging table from pack_aes_groups' output and the slice
    bounds: (hdr int32 [n_slices, AES_HDR], srows int32). Slice s stages
    srows[h0, h0 + h1) and weight rows [h2, h2 + h3); kind k's items in it
    are h[4 + 3k] with their rows at h[5 + 3k] in the slice's rows (field
    f of item j at + f * count + j) and first weight row at h[6 + 3k] in
    the slice's weight rows. Lookup j's weight rows are 4j + c; cum and
    every cumlk share the cum column's four."""
    kinds = _aes_kind_rows(idx, off, n, rows)
    counts = aes_item_counts(n)
    start = np.cumsum([0] + [counts[k] for k in AES_KINDS])
    # first weight row of each kind, and weight rows an item (every cumlk
    # item takes the cum column's four)
    per = {"lookup": 4, "table": 4, "cum": 4, "cumlk": 0}
    wstart, w = {}, 0
    for k in AES_KINDS:
        wstart[k] = wstart["cum"] if k == "cumlk" else w
        w += counts[k] * per.get(k, 1)
    hdr = np.zeros((len(bounds) - 1, AES_HDR), dtype=np.int32)
    parts, at = [], 0
    for s, (i0, i1) in enumerate(zip(bounds[:-1], bounds[1:])):
        h, mine, wlo, whi = hdr[s], [], None, None
        for k, (kind, fields) in enumerate(zip(AES_KINDS, kinds)):
            a, b = max(i0, start[k]) - start[k], min(i1, start[k + 1]) - start[k]
            cnt = max(0, b - a)
            h[4 + 3 * k] = cnt
            if not cnt:
                continue
            h[5 + 3 * k] = sum(len(m) for m in mine)
            mine.append(fields[:, a:a + cnt].reshape(-1))
            lo = wstart[kind] + a * per.get(kind, 1)
            hi = lo + (4 if kind == "cumlk" else cnt * per.get(kind, 1))
            wlo = lo if wlo is None else min(wlo, lo)
            whi = hi if whi is None else max(whi, hi)
            h[6 + 3 * k] = lo
        nrows = sum(len(m) for m in mine)
        if nrows > AES_ROWS_MAX or whi - wlo > AES_WEIGHTS_MAX:
            raise ValueError(f"aes_slice_table: slice {s} stages {nrows} rows, "
                             f"{whi - wlo} weight rows")
        for k in range(len(AES_KINDS)):
            if h[4 + 3 * k]:
                h[6 + 3 * k] -= wlo
        h[:4] = (at, nrows, wlo, whi - wlo)
        parts += mine
        at += nrows
    return hdr, np.concatenate(parts).astype(np.int32)


def aes_composition_plan(M: int) -> tuple:
    """K7d's launch shape at M points: (points a thread, threads a block)
    as composition_plan's, and whether consecutive blocks take the slices
    of one point tile (slices_first: from AES_SLICES_FIRST_TILES tiles) or
    the point tiles of one slice."""
    _, points, threads = composition_plan(M)
    tiles = -(-M // (points * threads))
    return points, threads, tiles >= AES_SLICES_FIRST_TILES


def aes_composition(vals: torch.Tensor, perm: torch.Tensor, table: tuple,
                    za: tuple, weights: torch.Tensor, vn_inv: torch.Tensor) -> torch.Tensor:
    """K7d: Q = (sum_k w_k c_k) / V_N as int32 [4, M] for the AES AIR from
    vals [R, M], sigma as the index map perm [M], table = (hdr, srows, n,
    max_row): aes_slice_table's arrays on the device, pack_aes_groups' n
    and the largest row they name; za = z (4) + alpha (4) of the LogUp
    draw, weights [K, 4] and vn_inv [M], in the launch shape
    aes_composition_plan(M). Two launches: the sliced sums, then K7c's
    total."""
    _check(vals, "aes_composition vals")
    if vals.dim() != 2:
        raise ValueError(f"aes_composition: expected vals [R, M], got {tuple(vals.shape)}")
    R, M = vals.shape
    hdr, srows, n, max_row = table
    if len(n) != 6 or len(za) != 8:
        raise ValueError("aes_composition: expected six index groups and 8 "
                         "challenge components")
    n_slices = hdr.shape[0]
    _check(perm, "aes_composition perm", shape=(M,))
    _check(hdr, "aes_composition hdr", shape=(n_slices, AES_HDR))
    _check(srows, "aes_composition rows")
    _check(weights, "aes_composition weights", shape=(aes_n_constraints(n), 4))
    _check(vn_inv, "aes_composition vn_inv", shape=(M,))
    for t in (perm, hdr, srows, weights, vn_inv):
        if t.device != vals.device:
            raise ValueError("aes_composition: operands on different devices")
    if not 0 <= max_row < R:
        raise ValueError("aes_composition: a staged row lies outside vals")
    if not all(0 <= v < (1 << 31) - 1 for v in za):
        raise ValueError("aes_composition: a challenge component is not canonical")
    if not 1 <= n_slices <= 65535:
        raise ValueError(f"aes_composition: {n_slices} slices")
    points, threads, slices_first = aes_composition_plan(M)
    if vals.data_ptr() % (4 * points) or weights.data_ptr() % 16:
        raise ValueError("aes_composition: vals or weights misaligned")
    partial = torch.empty((n_slices, 4, M), dtype=torch.int32, device=vals.device)
    out = torch.empty((4, M), dtype=torch.int32, device=vals.device)
    if M == 0:
        return out
    rc = _lib().zksc_aes_composition(
        vals.data_ptr(), M, perm.data_ptr(), (ctypes.c_uint * 8)(*za),
        hdr.data_ptr(), srows.data_ptr(), n_slices, weights.data_ptr(), points,
        threads, int(R * M >= WIDE_OFFSETS_FROM), int(slices_first),
        partial.data_ptr(), vn_inv.data_ptr(), out.data_ptr(), _stream(vals))
    _raise_on(rc, "aes_composition")
    LAUNCHES["aes_composition"] += 2   # aes_composition_kernel, composition_finish_kernel
    return out

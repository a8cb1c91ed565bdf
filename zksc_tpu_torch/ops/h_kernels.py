"""Wrappers of the hand-written CUDA kernels of the Groth16 quotient H(x)
over BN254 Fr: work the reference leaves to XLA to fuse (no pl.pallas_call),
written by hand because PyTorch eager ran it as ~40K launches a pass.

  - fr_elementwise (K0): ``to_mont`` (replaces the Fr.to_mont of
    zksc_tpu/groth16/prove.py:_witnesses_to_device), ``quotient``, h =
    (a b - c) / Z_H on the coset in one pass (the Fr.mont_mul / Fr.sub of
    zksc_tpu/groth16/prove.py:_h_core), ``pack_z`` (the mat-vec's z as
    packed words) and ``cross_stage`` (one half of a butterfly stage whose
    span crosses the blocks of a mesh: zksc_tpu/ops/ntt_sharded.py's
    cross_dif / cross_dit).
  - sparse_matvec (K5): <M, z> per constraint row of the A, B and C
    matrices stacked as one CSR matrix (``CSR``: rows binned by length,
    coefficients classed as +-1, +-c < 2^32 or wide); replaces
    zksc_tpu/groth16/prove.py:_matvec.
  - ntt (K4): a transform as two launches a direction of stage groups in
    shared memory (``ntt_plan``: the tile picked from the grid), with the
    product by one table folded into the launch of the smallest spans;
    replaces zksc_tpu/ops/ntt.py:dif_inverse, dit_forward,
    coset_evals_from_coeffs_br and coeffs_br_from_coset_evals.
    ops/ntt.py:NTTContext calls it with its tables, ops/ntt_sharded.py with
    a mesh block's C-point tables.

Source: ``csrc/h_kernels.cu`` (with ``csrc/bn254.cuh``'s Fr product),
compiled for sm_90a by one plain ``nvcc`` call into ``build/libzksc_h.so``
at first use (ops/cuda_build.py) and loaded with ctypes.

Layout: Fr elements as fields/limb.py's limb-major int32 [16, *batch]
(Montgomery form, canonical); tables, the wide coefficients and the
mat-vec's z are passed to the kernels packed as [count, 8] 32-bit words
(``pack_words``, ``pack_z``).

Dispatch: a tensor on the CPU goes to the plain PyTorch version (K0, K5:
the ``*_plain`` functions here; K4: NTTContext._transform_plain and
ShardedNTT._local_plain); a CUDA tensor goes to the kernel, which launches
on the current stream without synchronising, or the wrapper raises. There
is no fallback from the kernel to the plain version. ``LAUNCHES`` counts
real kernel launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..fields.limb import Fr
from . import cuda_build

LAUNCHES = {"fr_elementwise": 0, "sparse_matvec": 0, "ntt_group": 0}

# K4's tile: ntt_plan picks 2^t elements a block, t <= LOG_TILE, the
# largest for which the launch has MIN_BLOCKS blocks (two a streaming
# multiprocessor of an H100), but no less than half the stages, so that a
# transform stays two launches a direction. The kernel takes up to 2^11
# (its kNttMaxLogTile: the tile and both directions' twiddles in 192 KB of
# shared memory).
LOG_TILE = 10
MAX_LOG_TILE = 11
MIN_BLOCKS = 264

# K5's bins by row length (terms): up to SHORT_ROW a thread a (row,
# proof), up to WARP_ROW a warp, above that a block of 128 threads.
SHORT_ROW = 16
WARP_ROW = 1024
# K5's term kinds (the kernel's TermKind) and where they sit in a term's
# first word, above the column
TERM_ONE, TERM_MINUS_ONE, TERM_SMALL, TERM_MINUS_SMALL, TERM_WIDE = range(5)
TERM_KIND_SHIFT = 29

# K0's modes (the kernel's K0Mode)
TO_MONT, QUOTIENT, PACK, DIF_HALF, DIT_HALF = range(5)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib):
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    words = ctypes.POINTER(ctypes.c_uint32)
    lib.zksc_fr_elementwise.restype = ci
    lib.zksc_fr_elementwise.argtypes = [ci, vp, cll, vp, cll, vp, cll, cll,
                                        cll, ci, words, vp, cll, vp]
    lib.zksc_sparse_matvec.restype = ci
    lib.zksc_sparse_matvec.argtypes = [vp, cll, cll, vp, vp, vp, vp, cll, cll,
                                       cll, vp, cll, cll, vp]
    lib.zksc_ntt_group.restype = ci
    lib.zksc_ntt_group.argtypes = [vp, vp, cll, cll, ci, ci, ci, ci, ci, ci,
                                   vp, vp, vp, cll, vp]


def _lib():
    return cuda_build.load("h", _declare)


def _on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel on t (else its plain version):
    every tensor but a CPU one."""
    return t.device.type != "cpu"


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(t: torch.Tensor, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")


def _check(t: torch.Tensor, what: str, dim: int | None = None):
    _require_cuda(t, what)
    if t.dtype != torch.int32:
        raise ValueError(f"{what}: expected int32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if dim is not None and t.dim() != dim:
        raise ValueError(f"{what}: expected {dim} dimensions, got "
                         f"{tuple(t.shape)}")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def pack_words(limbs: torch.Tensor) -> torch.Tensor:
    """[16, *batch] limbs -> [count, 8] int32 words, element after element
    (word k = limb 2k | limb 2k+1 << 16), as the kernels read a table."""
    lo = limbs[0::2].reshape(8, -1).to(torch.int64)
    hi = limbs[1::2].reshape(8, -1).to(torch.int64)
    return _as_int32(lo | (hi << 16)).T.contiguous()


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """[*batch, 8] int32 words -> [16, *batch] limbs (pack_words' inverse)."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1)
    limbs = limbs.reshape(*words.shape[:-1], 16)
    return limbs.movedim(-1, 0).to(torch.int32).contiguous()


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _words(v: int):
    """The eight 32-bit words of v < 2^256, as a C array."""
    return (ctypes.c_uint32 * 8)(*((v >> (32 * i)) & 0xFFFFFFFF
                                   for i in range(8)))


# ---------------------------------------------------------------- K0

def to_mont(x: torch.Tensor) -> torch.Tensor:
    """Canonical residues [16, *batch] -> Montgomery form (Fr.to_mont; K0
    on a CUDA tensor)."""
    if not _on_card(x):
        return Fr.to_mont(x)
    return _launch_to_mont(x)


def quotient_plain(abc: torch.Tensor, zinv: int) -> torch.Tensor:
    """Plain K0 quotient: abc [16, 3, *batch] (a, b, c Montgomery) ->
    (a b - c) zinv [16, *batch], the composition of the reference's
    _h_core."""
    a, b, c = abc[:, 0], abc[:, 1], abc[:, 2]
    z = Fr.broadcast_const(zinv, (1,) * (a.dim() - 1), device=abc.device)
    return Fr.mont_mul(Fr.sub(Fr.mont_mul(a, b), c), z)


def quotient(abc: torch.Tensor, zinv: int) -> torch.Tensor:
    """h = (a b - c) zinv over abc [16, 3, *batch] in Montgomery form
    (K0 on a CUDA tensor): the quotient's evaluations on the coset for a
    host-known zinv = 1 / Z_H(coset)."""
    if not _on_card(abc):
        return quotient_plain(abc, zinv)
    return _launch_quotient(abc, zinv)


def pack_z_plain(z_mont: torch.Tensor) -> torch.Tensor:
    """Plain K0 pack: z_mont [16, k, m_pad] -> [k, m_pad, 8] words."""
    return pack_words(z_mont).reshape(*z_mont.shape[1:], 8)


def pack_z(z_mont: torch.Tensor) -> torch.Tensor:
    """The witnesses as the mat-vec reads them: z_mont [16, k, m_pad]
    (Montgomery limbs) -> [k, m_pad, 8] int32 words, one 32-byte element a
    row (K0 on a CUDA tensor)."""
    if not _on_card(z_mont):
        return pack_z_plain(z_mont)
    _check(z_mont, "pack_z", 3)
    out = torch.empty((*z_mont.shape[1:], 8), dtype=torch.int32,
                      device=z_mont.device)
    return _launch_elementwise(PACK, z_mont, None, out, "pack_z")


def _twiddles(tw: torch.Tensor, t0: int, stride: int, C: int) -> torch.Tensor:
    """Limbs [16, C] of the packed table entries tw[(t0 + i) stride]."""
    idx = (t0 + torch.arange(C, device=tw.device)) * stride
    return unpack_words(tw[idx])


def cross_stage_plain(x, other, tw, t0: int, stride: int, dif: bool,
                      v_half: bool):
    """Plain K0 cross stage, the reference's cross_dif / cross_dit on one
    block: x, other [16, *rows, C] (this block, the partner's), element i's
    twiddle tw[(t0 + i) stride] of a packed [*, 8] table. DIF: the u half
    x + other, the v half (other - x) w; DIT: the u half x + other w, the
    v half other - x w."""
    C = x.shape[-1]
    if dif and not v_half:
        return Fr.add(x, other)
    w = _twiddles(tw, t0, stride, C)
    w = w.reshape(Fr.L, *([1] * (x.dim() - 2)), C)
    if dif:
        return Fr.mont_mul(Fr.sub(other, x), w)
    if v_half:
        return Fr.sub(other, Fr.mont_mul(x, w))
    return Fr.add(x, Fr.mont_mul(other, w))


def cross_stage(x, other, tw, t0: int, stride: int, dif: bool,
                v_half: bool):
    """One half of a butterfly stage whose span crosses the blocks of a
    mesh (ops/ntt_sharded.py), over x and other [16, *rows, C] (K0 on CUDA
    tensors); see cross_stage_plain."""
    if not _on_card(x):
        return cross_stage_plain(x, other, tw, t0, stride, dif, v_half)
    _check(x, "cross_stage x")
    _check(other, "cross_stage other")
    _check(tw, "cross_stage twiddles", 2)
    if other.shape != x.shape or other.device != x.device \
            or tw.device != x.device or tw.shape[1] != 8:
        raise ValueError(f"cross_stage: x {tuple(x.shape)} on {x.device}, "
                         f"other {tuple(other.shape)} on {other.device}, "
                         f"twiddles {tuple(tw.shape)} on {tw.device}")
    C = x.shape[-1]
    if (t0 + C - 1) * stride >= tw.shape[0] or t0 < 0 or stride < 1:
        raise ValueError(f"cross_stage: twiddles ({t0} + i) {stride} outside "
                         f"a table of {tw.shape[0]}")
    out = torch.empty_like(x)
    return _launch_elementwise(DIF_HALF if dif else DIT_HALF, x, None, out,
                               "cross_stage", other=other, tw=tw,
                               tw_off=t0 * stride, stride=stride, period=C,
                               v_half=v_half)


def _launch_quotient(abc, zinv: int):
    _check(abc, "quotient")
    if abc.dim() < 2 or abc.shape[1] != 3:
        raise ValueError(f"quotient: expected [16, 3, *batch], got "
                         f"{tuple(abc.shape)}")
    out = torch.empty((Fr.L, *abc.shape[2:]), dtype=torch.int32,
                      device=abc.device)
    return _launch_elementwise(QUOTIENT, abc, zinv * (1 << 256) % Fr.p, out,
                               "quotient")


def _launch_to_mont(x):
    _check(x, "to_mont")
    return _launch_elementwise(TO_MONT, x, Fr.R2_int, torch.empty_like(x),
                               "to_mont")


def _launch_elementwise(mode: int, x, k, out, what: str, other=None,
                        tw=None, tw_off: int = 0, stride: int = 0,
                        period: int = 0, v_half: bool = False):
    """K0 over the elements of out ([16, *batch], or [*batch, 8] words for
    PACK) from x [16, *batch] (QUOTIENT: [16, 3, *batch]); k a raw 256-bit
    residue, the other operand of the Montgomery product (TO_MONT,
    QUOTIENT)."""
    if x.shape[0] != Fr.L:
        raise ValueError(f"{what}: expected {Fr.L} limbs, got {x.shape[0]}")
    N = out.numel() // (8 if mode == PACK else Fr.L)
    if N == 0:
        return out
    rc = _lib().zksc_fr_elementwise(
        mode, x.data_ptr(), x.stride(0),
        None if other is None else other.data_ptr(),
        0 if other is None else other.stride(0),
        None if tw is None else tw.data_ptr(), tw_off, stride, period,
        int(v_half), None if k is None else _words(k), out.data_ptr(), N,
        _stream(x))
    _raise_on(rc, f"fr_elementwise ({what})")
    LAUNCHES["fr_elementwise"] += 1
    return out


# ---------------------------------------------------------------- K5

@dataclass
class CSR:
    """M sparse matrices of n rows each, stacked (matrix m's row i is row
    m n + i), in CSR form.

    For the plain version: rows [nnz] int64 (the stacked row of each
    entry), cols [nnz] int32 and coeffs [16, nnz] (Montgomery limbs). For
    the kernel: row_ptr [M n + 1] int32; terms [nnz, 2] int32, a term's
    column | kind << TERM_KIND_SHIFT and its value (the coefficient c of
    the TERM_SMALL kinds, +c or -c mod r with c < 2^32; the index into
    `wide` of a TERM_WIDE term; 1 for the +-1 kinds); wide [n_wide, 8]
    packed Montgomery coefficients; bin_rows [M n] int32, the stacked rows
    of at most SHORT_ROW terms (empty ones too), then those of at most
    WARP_ROW, then the longer ones, each bin in row order, with `bins` the
    three counts. width: one more than the largest column."""
    M: int
    n: int
    width: int
    row_ptr: torch.Tensor
    cols: torch.Tensor
    rows: torch.Tensor
    coeffs: torch.Tensor
    terms: torch.Tensor
    wide: torch.Tensor
    bin_rows: torch.Tensor
    bins: tuple

    @classmethod
    def stack(cls, mats: list, n: int) -> "CSR":
        """mats: [(rows [nnz] int64, cols [nnz] int64, coeffs [16, nnz])]
        in COO form, each matrix's entries ordered by row (the constraint
        order ProverContext builds them in)."""
        M = len(mats)
        for r, c, _ in mats:
            if r.numel() and (int(r.min()) < 0 or int(r.max()) >= n
                              or int(c.min()) < 0):
                raise ValueError(f"CSR: a row outside [0, {n}) or a "
                                 "negative column")
        rows = torch.cat([r + m * n for m, (r, _, _) in enumerate(mats)])
        cols = torch.cat([c for _, c, _ in mats])
        if bool((rows[1:] < rows[:-1]).any()):
            raise ValueError("CSR: entries not ordered by row")
        width = int(cols.max()) + 1 if cols.numel() else 0
        if width > 1 << TERM_KIND_SHIFT:
            raise ValueError(f"CSR: column {width - 1} does not fit a term")
        counts = torch.bincount(rows, minlength=M * n)
        row_ptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
        coeffs = torch.cat([v for _, _, v in mats], dim=1)
        kind, value, wide = _classes(coeffs)
        first = cols.to(torch.int64) | (kind << TERM_KIND_SHIFT)
        terms = torch.stack([_as_int32(first), _as_int32(value)], dim=1)
        short, long_ = counts <= SHORT_ROW, counts > WARP_ROW
        bins = [short, ~short & ~long_, long_]
        bin_rows = torch.cat([torch.nonzero(b).flatten() for b in bins])
        return cls(M, n, width, row_ptr.to(torch.int32),
                   cols.to(torch.int32), rows, coeffs, terms.contiguous(),
                   pack_words(wide) if wide.shape[1] else
                   torch.zeros((1, 8), dtype=torch.int32,
                               device=coeffs.device),
                   bin_rows.to(torch.int32), tuple(int(b.sum()) for b in bins))

    def to(self, device) -> "CSR":
        """This CSR with every tensor on `device`."""
        mv = lambda t: t.to(device)
        return CSR(self.M, self.n, self.width, mv(self.row_ptr),
                   mv(self.cols), mv(self.rows), mv(self.coeffs),
                   mv(self.terms), mv(self.wide), mv(self.bin_rows),
                   self.bins)


def _small(limbs: torch.Tensor):
    """(values < 2^32, their value) of canonical limbs [16, nnz]."""
    return ((limbs[2:] == 0).all(0),
            limbs[0].to(torch.int64) | (limbs[1].to(torch.int64) << 16))


def _classes(coeffs: torch.Tensor):
    """K5's coefficient classes: Montgomery coefficients [16, nnz] ->
    (kind [nnz] int64, value [nnz] int64, the wide coefficients [16,
    n_wide] in Montgomery form)."""
    plain = Fr.from_mont(coeffs)
    pos, pv = _small(plain)
    neg, nv = _small(Fr.neg(plain))
    neg &= ~pos
    kind = torch.full(pos.shape, TERM_WIDE, dtype=torch.int64,
                      device=coeffs.device)
    kind[pos] = TERM_SMALL
    kind[neg] = TERM_MINUS_SMALL
    kind[pos & (pv == 1)] = TERM_ONE
    kind[neg & (nv == 1)] = TERM_MINUS_ONE
    is_wide = kind == TERM_WIDE
    value = torch.where(pos, pv, torch.where(neg, nv,
                                             torch.cumsum(is_wide, 0) - 1))
    return kind, value, coeffs[:, is_wide]


def sparse_matvec_plain(z_words: torch.Tensor, csr: CSR) -> torch.Tensor:
    """Plain K5, the reference's _matvec over the stacked rows: z_words
    [k, m_pad, 8] (pack_z of the Montgomery witnesses) -> [16, M, k, n]
    Montgomery row sums (a gather, one product a nonzero, a lazy per-limb
    segment sum; each limb < 2^16 and rows have < 2^16 terms, so the int64
    sums hold)."""
    z_mont = unpack_words(z_words)
    L, k = z_mont.shape[0], z_mont.shape[1]
    prod = Fr.mont_mul(z_mont[:, :, csr.cols.long()], csr.coeffs[:, None, :])
    sums = torch.zeros((L, k, csr.M * csr.n), dtype=torch.int64,
                       device=z_mont.device)
    sums.index_add_(2, csr.rows, prod.to(torch.int64))
    norm = Fr.normalize_u32_limbs([sums[j] for j in range(L)])
    out = Fr.to_mont(Fr.mont_reduce_wide(norm))     # drops, restores one R
    # a copy at every k (contiguous() would skip it at k = 1)
    return out.reshape(L, k, csr.M, csr.n).transpose(1, 2).clone(
        memory_format=torch.contiguous_format)


def sparse_matvec(z_words: torch.Tensor, csr: CSR) -> torch.Tensor:
    """<M_m, z_j> for every matrix m and proof j: z_words [k, m_pad, 8]
    (pack_z of the Montgomery witnesses) -> [16, M, k, n] Montgomery (K5 on
    a CUDA tensor)."""
    if not _on_card(z_words):
        return sparse_matvec_plain(z_words, csr)
    return _launch_sparse_matvec(z_words, csr)


def _launch_sparse_matvec(z_words: torch.Tensor, csr: CSR) -> torch.Tensor:
    _check(z_words, "sparse_matvec z", 3)
    for t, what in ((csr.row_ptr, "row_ptr"), (csr.terms, "terms"),
                    (csr.wide, "wide coefficients"),
                    (csr.bin_rows, "bin rows")):
        _check(t, f"sparse_matvec {what}")
        if t.device != z_words.device:
            raise ValueError(f"sparse_matvec: {what} on {t.device}, z on "
                             f"{z_words.device}")
    k, m_pad, eight = z_words.shape
    if eight != 8:
        raise ValueError(f"sparse_matvec: expected z as [k, m_pad, 8] "
                         f"words, got {tuple(z_words.shape)}")
    if csr.width > m_pad:
        raise ValueError(f"sparse_matvec: column {csr.width - 1} of a "
                         f"witness of {m_pad}")
    out = torch.empty((Fr.L, csr.M, k, csr.n), dtype=torch.int32,
                      device=z_words.device)
    if out.numel() == 0:
        return out
    n0, n1, n2 = csr.bins
    rc = _lib().zksc_sparse_matvec(
        z_words.data_ptr(), m_pad, k, csr.row_ptr.data_ptr(),
        csr.terms.data_ptr(), csr.wide.data_ptr(), csr.bin_rows.data_ptr(),
        n0, n1, n2, out.data_ptr(), csr.n, csr.M, _stream(z_words))
    _raise_on(rc, "sparse_matvec")
    LAUNCHES["sparse_matvec"] += 1
    return out


# ---------------------------------------------------------------- K4

def pick_log_tile(log_n: int, rows: int) -> int:
    """K4's tile for `rows` transforms of 2^log_n: the largest t <=
    LOG_TILE whose launch has MIN_BLOCKS blocks, but at least half the
    stages (two stage groups)."""
    t = min(LOG_TILE, log_n)
    while t > (log_n + 1) // 2 and rows << (log_n - t) < MIN_BLOCKS:
        t -= 1
    return t


def ntt_plan(log_n: int, log_tile: int | None = None, rows: int = 1) -> list:
    """K4's stage groups of `rows` transforms of 2^log_n, in DIF order (the
    largest spans first): (top, ns, tl) = the group's largest global
    half-span 2^top, its ns stages, and 2^tl consecutive low indices a
    tile, each tile 2^log_tile elements (all of them when the transform is
    shorter). log_tile: pick_log_tile's unless given. The last group, the
    smallest spans, reads contiguous chunks (tl = 0)."""
    if log_tile is None:
        log_tile = pick_log_tile(log_n, rows)
    if not 1 <= log_tile <= MAX_LOG_TILE:
        raise ValueError(f"ntt_plan: log_tile {log_tile} outside "
                         f"[1, {MAX_LOG_TILE}]")
    chunk = min(log_n, log_tile)
    groups = [(chunk - 1, chunk, 0)]
    bot = chunk
    while bot < log_n:
        ns = min(log_n - bot, log_tile)
        groups.append((bot + ns - 1, ns, log_tile - ns))
        bot += ns
    return groups[::-1]


def ntt(x: torch.Tensor, tw_inv: torch.Tensor, tw_fwd: torch.Tensor,
        dif: bool, dit: bool, scale: torch.Tensor | None = None,
        log_tile: int | None = None) -> torch.Tensor:
    """K4: every DIF stage (natural -> bit-reversed), then the product by
    `scale`, then every DIT stage (bit-reversed -> natural) over each row
    of x [16, *rows, n] (Montgomery, CUDA). tw_inv / tw_fwd: [n / 2, 8]
    packed powers w^-e / w^e; scale: None, [n, 8] (by position) or [1, 8]
    (one constant) packed words. ntt_plan(log n, log_tile, rows) launches:
    the DIF groups, the smallest spans' group (with the scale, and both
    directions when both run), the DIT groups. Returns a new tensor."""
    what = "ntt"
    _check(x, what)
    if not (dif or dit):
        raise ValueError("ntt: neither DIF nor DIT stages")
    L, n = x.shape[0], x.shape[-1]
    log_n = n.bit_length() - 1
    if L != Fr.L or n < 2 or n != 1 << log_n:
        raise ValueError(f"ntt: expected [16, *rows, 2^k], got "
                         f"{tuple(x.shape)}")
    for t, count, name in ((tw_inv, n // 2, "tw_inv"),
                           (tw_fwd, n // 2, "tw_fwd"),
                           (scale, None, "scale")):
        if t is None:
            continue
        _check(t, f"ntt {name}", 2)
        if t.shape[1] != 8 or (count is not None and t.shape[0] != count) \
                or (count is None and t.shape[0] not in (1, n)):
            raise ValueError(f"ntt: {name} of shape {tuple(t.shape)} for "
                             f"n = {n}")
        if t.device != x.device:
            raise ValueError(f"ntt: {name} on {t.device}, x on {x.device}")
    rows = x.numel() // (L * n)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    plan = ntt_plan(log_n, log_tile, rows)
    steps = [(g, True, False, None) for g in plan[:-1]] if dif else []
    steps.append((plan[-1], dif, dit, scale))
    if dit:
        steps += [(g, False, True, None) for g in reversed(plan[:-1])]
    lib, st, src = _lib(), _stream(x), x
    for (top, ns, tl), d, t, sc in steps:
        rc = lib.zksc_ntt_group(
            src.data_ptr(), out.data_ptr(), x.stride(0), rows, log_n, top,
            ns, tl, int(d), int(t), tw_inv.data_ptr(), tw_fwd.data_ptr(),
            None if sc is None else sc.data_ptr(),
            0 if sc is None or sc.shape[0] == 1 else 1, st)
        _raise_on(rc, "ntt_group")
        LAUNCHES["ntt_group"] += 1
        src = out
    return out

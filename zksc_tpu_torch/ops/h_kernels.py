"""Wrappers of the hand-written CUDA kernels of the Groth16 quotient H(x)
over BN254 Fr: work the reference leaves to XLA to fuse (no pl.pallas_call),
written by hand because PyTorch eager ran it as ~40K launches a pass.

  - fr_elementwise (K0): ``to_mont`` (replaces the Fr.to_mont of
    zksc_tpu/groth16/prove.py:_witnesses_to_device) and ``quotient``, h =
    (a b - c) / Z_H on the coset in one pass (the Fr.mont_mul / Fr.sub of
    zksc_tpu/groth16/prove.py:_h_core).
  - sparse_matvec (K5): <M, z> per constraint row of the A, B and C
    matrices stacked as one CSR matrix (``CSR``); replaces
    zksc_tpu/groth16/prove.py:_matvec.
  - ntt (K4): a transform as a few launches of stage groups in shared
    memory (``ntt_plan``), with the product by one table folded into the
    launch of the smallest spans; replaces zksc_tpu/ops/ntt.py:dif_inverse,
    dit_forward, coset_evals_from_coeffs_br and coeffs_br_from_coset_evals.
    ops/ntt.py:NTTContext calls it with its tables.

Source: ``csrc/h_kernels.cu`` (with ``csrc/bn254.cuh``'s Fr product),
compiled for sm_90a by one plain ``nvcc`` call into ``build/libzksc_h.so``
at first use (ops/cuda_build.py) and loaded with ctypes.

Layout: Fr elements as fields/limb.py's limb-major int32 [16, *batch]
(Montgomery form, canonical); tables and the mat-vec's coefficients are
passed to the kernels packed as [count, 8] 32-bit words (``pack_words``).

Dispatch: a tensor on the CPU goes to the plain PyTorch version (K0, K5:
the ``*_plain`` functions here; K4: NTTContext._transform_plain); a CUDA
tensor goes to the kernel, which launches on the current stream without
synchronising, or the wrapper raises. There is no fallback from the kernel
to the plain version. ``LAUNCHES`` counts real kernel launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..fields.limb import Fr
from . import cuda_build

LAUNCHES = {"fr_elementwise": 0, "sparse_matvec": 0, "ntt_group": 0}

# K4's tile: 2^LOG_TILE elements a block (64 KB of shared memory); a
# transform of 2^log_n elements runs ceil(log_n / LOG_TILE) stage groups.
# The kernel takes up to 2^12 (its kNttMaxLogTile).
LOG_TILE = 11
MAX_LOG_TILE = 12


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _declare(lib):
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    words = ctypes.POINTER(ctypes.c_uint32)
    lib.zksc_fr_elementwise.restype = ci
    lib.zksc_fr_elementwise.argtypes = [ci, vp, cll, words, vp, cll, vp]
    lib.zksc_sparse_matvec.restype = ci
    lib.zksc_sparse_matvec.argtypes = [vp, cll, cll, vp, vp, vp, vp, cll, cll,
                                       vp]
    lib.zksc_ntt_group.restype = ci
    lib.zksc_ntt_group.argtypes = [vp, vp, cll, cll, ci, ci, ci, ci, ci, ci,
                                   vp, vp, vp, cll, vp]


def _lib():
    return cuda_build.load("h", _declare)


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
    w = lo | (hi << 16)
    w = torch.where(w >= 1 << 31, w - (1 << 32), w)
    return w.T.contiguous().to(torch.int32)


def _words(v: int):
    """The eight 32-bit words of v < 2^256, as a C array."""
    return (ctypes.c_uint32 * 8)(*((v >> (32 * i)) & 0xFFFFFFFF
                                   for i in range(8)))


# ---------------------------------------------------------------- K0

def to_mont(x: torch.Tensor) -> torch.Tensor:
    """Canonical residues [16, *batch] -> Montgomery form (Fr.to_mont; K0
    on a CUDA tensor)."""
    if x.device.type == "cpu":
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
    if abc.device.type == "cpu":
        return quotient_plain(abc, zinv)
    return _launch_quotient(abc, zinv)


def _launch_quotient(abc, zinv: int):
    if abc.dim() < 2 or abc.shape[1] != 3:
        raise ValueError(f"quotient: expected [16, 3, *batch], got "
                         f"{tuple(abc.shape)}")
    return _launch_elementwise(abc, zinv * (1 << 256) % Fr.p, True,
                               "quotient")


def _launch_to_mont(x):
    return _launch_elementwise(x, Fr.R2_int, False, "to_mont")


def _launch_elementwise(x, k: int, quotient: bool, what: str):
    """K0: out = x k (to_mont: k = R^2) or, with `quotient`, (a b - c) k
    over the three parts of x [16, 3, *batch]; k a raw 256-bit residue, the
    other operand of the Montgomery product."""
    _check(x, what)
    if x.shape[0] != Fr.L:
        raise ValueError(f"{what}: expected {Fr.L} limbs, got {x.shape[0]}")
    batch = tuple(x.shape[2:] if quotient else x.shape[1:])
    out = torch.empty((Fr.L, *batch), dtype=torch.int32, device=x.device)
    N = out[0].numel()
    if N == 0:
        return out
    rc = _lib().zksc_fr_elementwise(int(quotient), x.data_ptr(), x.stride(0),
                                    _words(k), out.data_ptr(), N, _stream(x))
    _raise_on(rc, f"fr_elementwise ({what})")
    LAUNCHES["fr_elementwise"] += 1
    return out


# ---------------------------------------------------------------- K5

@dataclass
class CSR:
    """M sparse matrices of n rows each, stacked (matrix m's row i is row
    m n + i), in CSR form: row_ptr [M n + 1] int32, cols [nnz] int32 and
    coeff_words [nnz, 8] (packed Montgomery coefficients) for the kernel;
    rows [nnz] int64 (the stacked row of each entry) and coeffs [16, nnz]
    for the plain version; width: one more than the largest column."""
    M: int
    n: int
    width: int
    row_ptr: torch.Tensor
    cols: torch.Tensor
    rows: torch.Tensor
    coeffs: torch.Tensor
    coeff_words: torch.Tensor

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
        counts = torch.bincount(rows, minlength=M * n)
        row_ptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
        coeffs = torch.cat([v for _, _, v in mats], dim=1)
        width = int(cols.max()) + 1 if cols.numel() else 0
        return cls(M, n, width, row_ptr.to(torch.int32),
                   cols.to(torch.int32), rows, coeffs, pack_words(coeffs))


def sparse_matvec_plain(z_mont: torch.Tensor, csr: CSR) -> torch.Tensor:
    """Plain K5, the reference's _matvec over the stacked rows: z_mont
    [16, k, m_pad] -> [16, M, k, n] Montgomery row sums (a gather, one
    product a nonzero, a lazy per-limb segment sum; each limb < 2^16 and
    rows have < 2^16 terms, so the int64 sums hold)."""
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


def sparse_matvec(z_mont: torch.Tensor, csr: CSR) -> torch.Tensor:
    """<M_m, z_j> for every matrix m and proof j: z_mont [16, k, m_pad]
    (Montgomery) -> [16, M, k, n] Montgomery (K5 on a CUDA tensor)."""
    if z_mont.device.type == "cpu":
        return sparse_matvec_plain(z_mont, csr)
    return _launch_sparse_matvec(z_mont, csr)


def _launch_sparse_matvec(z_mont: torch.Tensor, csr: CSR) -> torch.Tensor:
    _check(z_mont, "sparse_matvec z", 3)
    for t, what in ((csr.row_ptr, "row_ptr"), (csr.cols, "cols"),
                    (csr.coeff_words, "coefficients")):
        _check(t, f"sparse_matvec {what}")
        if t.device != z_mont.device:
            raise ValueError(f"sparse_matvec: {what} on {t.device}, z on "
                             f"{z_mont.device}")
    L, k, m_pad = z_mont.shape
    if csr.width > m_pad:
        raise ValueError(f"sparse_matvec: column {csr.width - 1} of a "
                         f"witness of {m_pad}")
    out = torch.empty((L, csr.M, k, csr.n), dtype=torch.int32,
                      device=z_mont.device)
    if out.numel() == 0:
        return out
    rc = _lib().zksc_sparse_matvec(
        z_mont.data_ptr(), m_pad, k, csr.row_ptr.data_ptr(),
        csr.cols.data_ptr(), csr.coeff_words.data_ptr(), out.data_ptr(),
        csr.n, csr.M, _stream(z_mont))
    _raise_on(rc, "sparse_matvec")
    LAUNCHES["sparse_matvec"] += 1
    return out


# ---------------------------------------------------------------- K4

def ntt_plan(log_n: int, log_tile: int = LOG_TILE) -> list:
    """K4's stage groups of a 2^log_n transform, in DIF order (the largest
    spans first): (top, ns, tl) = the group's largest global half-span
    2^top, its ns stages, and 2^tl consecutive low indices a tile, each
    tile 2^log_tile elements (all of them when the transform is shorter).
    The last group, the smallest spans, reads contiguous chunks (tl = 0)."""
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
        log_tile: int = LOG_TILE) -> torch.Tensor:
    """K4: every DIF stage (natural -> bit-reversed), then the product by
    `scale`, then every DIT stage (bit-reversed -> natural) over each row
    of x [16, *rows, n] (Montgomery, CUDA). tw_inv / tw_fwd: [n / 2, 8]
    packed powers w^-e / w^e; scale: None, [n, 8] (by position) or [1, 8]
    (one constant) packed words. ntt_plan(log n, log_tile) launches: the
    DIF groups, the smallest spans' group (with the scale, and both
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
    plan = ntt_plan(log_n, log_tile)
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

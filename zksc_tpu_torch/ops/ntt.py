"""Radix-2 NTT over BN254 Fr for the Groth16 H-polynomial.

The JAX package's ``ops/ntt.py`` pipeline, unchanged in its arithmetic:

  - Decimation-in-frequency (DIF) for transforms whose *output* order may
    stay bit-reversed, decimation-in-time (DIT) for transforms whose *input*
    is bit-reversed: no runtime bit-reversal permutation anywhere.
    Order-sensitive tables (coset shift powers) are precomputed in
    bit-reversed order on the host instead.
  - The plain version (a CPU tensor, and the reference the kernel is held
    to): each butterfly stage is a reshape + one batched Montgomery
    multiply (dif_stages / dit_stages). On a CUDA tensor every transform is
    K4 (ops/h_kernels.ntt: a few launches of stage groups in shared
    memory). Either way a transform's products by a table (1/n, the coset
    shift powers, and from_mont where asked) are one product by a table
    folded on the host side: the values are the same canonical residues.

The Groth16 coset pipeline (see groth16/prove.py):
  evals(natural) --DIF(w^-1, 1/n)--> coeffs(bitrev)
  coeffs(bitrev) * shift^i(bitrev)  --DIT(w)--> coset evals(natural)
  pointwise h = (a*b - c) * 1/Z_coset
  coset evals --DIF(w^-1, 1/n)--> then * shift^-i(bitrev) -> h coeffs(bitrev)
  (the H-basis MSM points are stored in bit-reversed order at setup time)
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields.limb import Fr, LimbField
from . import h_kernels


def bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def find_2adic_root(F: LimbField, n: int) -> int:
    """Primitive n-th root of unity in F (n a power of two)."""
    assert n & (n - 1) == 0
    two_adicity = 0
    m = F.p - 1
    while m % 2 == 0:
        m //= 2
        two_adicity += 1
    assert n <= (1 << two_adicity), "domain too large for field 2-adicity"
    for g in range(2, 100):
        root = pow(g, (F.p - 1) >> two_adicity, F.p)
        # root has order dividing 2^two_adicity; check it's exactly that
        if pow(root, 1 << (two_adicity - 1), F.p) != 1:
            w = pow(root, 1 << (two_adicity - (n.bit_length() - 1)), F.p)
            assert pow(w, n, F.p) == 1 and pow(w, n // 2, F.p) != 1
            return w
    raise RuntimeError("no generator found")


def _powers(base: int, count: int, p: int) -> list:
    out, acc = [], 1
    for _ in range(count):
        out.append(acc)
        acc = acc * base % p
    return out


def dif_stages(F: LimbField, x, tw_inv: dict, top: int):
    """DIF butterfly stages of spans top, top/2, ..., 2 over x [L, *batch, m]
    (m a multiple of top), each row on its own: (u, v) -> (u + v,
    (u - v) * tw). tw_inv[span]: the span's twiddles [L, span/2]."""
    shape = x.shape
    length = top
    while length >= 2:
        x = x.reshape(F.L, -1, length)
        u = x[:, :, : length // 2]
        v = x[:, :, length // 2:]
        hi = F.mont_mul(F.sub(u, v), tw_inv[length][:, None, :])
        x = torch.cat([F.add(u, v), hi], dim=2)
        length //= 2
    return x.reshape(shape)


def dit_stages(F: LimbField, x, tw_fwd: dict, top: int):
    """DIT butterfly stages of spans 2, 4, ..., top over x [L, *batch, m],
    each row on its own: (u, v) -> (u + v * tw, u - v * tw)."""
    shape = x.shape
    length = 2
    while length <= top:
        x = x.reshape(F.L, -1, length)
        u = x[:, :, : length // 2]
        v = x[:, :, length // 2:]
        vw = F.mont_mul(v, tw_fwd[length][:, None, :])
        x = torch.cat([F.add(u, vw), F.sub(u, vw)], dim=2)
        length *= 2
    return x.reshape(shape)


def _lift(c, x):
    """A table c [L, *tail] viewed with a singleton axis for each batch axis
    of x [L, *batch, *tail]. Left as it is, broadcasting would line c's
    limb axis up with x's first batch axis: wrong limbs, and no error when
    that axis has L entries."""
    return c.reshape(c.shape[0], *([1] * (x.dim() - c.dim())), *c.shape[1:])


class NTTContext:
    """Precomputed twiddle tables + transforms for a fixed power-of-two n,
    with every table on `device`."""

    def __init__(self, F: LimbField, n: int, coset_shift: int | None = None,
                 device=None):
        self.F = F
        self.n = n
        self.device = device
        self.w = find_2adic_root(F, n)
        self.w_inv = pow(self.w, -1, F.p)
        self.n_inv = pow(n, -1, F.p)
        # per-stage twiddle tables: for span `len`, powers (w^(n/len))^j, j<len/2
        self._tw_fwd = self._stage_tables(self.w)
        self._tw_inv = self._stage_tables(self.w_inv)
        self.bitrev = bit_reverse_perm(n)
        if coset_shift is None:
            coset_shift = 5
        assert pow(coset_shift, n, F.p) != 1, \
            "coset shift must lie outside the domain"
        self.shift = coset_shift
        br = self.bitrev
        shift_pows = _powers(coset_shift, n, F.p)
        shift_inv_pows = _powers(pow(coset_shift, -1, F.p), n, F.p)
        self.shift_pows_br = F.to_device(
            [shift_pows[int(br[i])] for i in range(n)], device=device)
        self.shift_inv_pows_br = F.to_device(
            [shift_inv_pows[int(br[i])] for i in range(n)], device=device)
        # Z_H(shift * w^i) = shift^n - 1 (constant on the coset)
        self.z_coset_int = (pow(coset_shift, n, F.p) - 1) % F.p
        self._ninv = F.broadcast_const(self.n_inv, (1,), device=device)
        # the tables a transform multiplies by ([L, n] or [L, 1]): 1/n, the
        # coset shift powers, their products with 1/n (shift^i / n,
        # shift^-i / n), and shift^-i / n as a plain residue (a Montgomery
        # product by it also leaves Montgomery form: from_mont folded in)
        ninv_shift_inv = F.mont_mul(self.shift_inv_pows_br, self._ninv)
        self._scales = {
            "ninv": self._ninv, "shift": self.shift_pows_br,
            "ninv_shift": F.mont_mul(self.shift_pows_br, self._ninv),
            "ninv_shift_inv": ninv_shift_inv,
            "ninv_shift_inv_plain": F.from_mont(ninv_shift_inv)}
        self._words = None
        if F is Fr and device is not None and \
                torch.device(device).type == "cuda":
            self._kernel_tables()

    def _stage_tables(self, w_root: int):
        F, n = self.F, self.n
        tables = {}
        length = n
        while length >= 2:
            wl = pow(w_root, n // length, F.p)
            tables[length] = F.to_device(_powers(wl, length // 2, F.p),
                                         device=self.device)
            length //= 2
        return tables

    def _kernel_tables(self):
        """K4's packed tables: the powers w^-e and w^e, e < n / 2 (the span-n
        stage tables), [n / 2, 8] words each, and every scale table."""
        if self._words is None:
            if self.F is not Fr:
                raise ValueError("the NTT kernel computes over BN254 Fr only")
            pack = h_kernels.pack_words
            self._words = (pack(self._tw_inv[self.n]),
                           pack(self._tw_fwd[self.n]),
                           {k: pack(v) for k, v in self._scales.items()})
        return self._words

    def _transform_plain(self, x, dif: bool, dit: bool, scale):
        """Plain K4: the DIF stages, the product by the table named `scale`
        (or none), the DIT stages, over x [L, *batch, n]; any device."""
        F = self.F
        if dif:
            x = dif_stages(F, x, self._tw_inv, self.n)
        if scale is not None:
            x = F.mont_mul(x, _lift(self._scales[scale], x))
        if dit:
            x = dit_stages(F, x, self._tw_fwd, self.n)
        return x

    def _transform(self, x, dif: bool, dit: bool, scale):
        """_transform_plain on a CPU tensor; K4 on a CUDA tensor."""
        if not h_kernels._on_card(x):
            return self._transform_plain(x, dif, dit, scale)
        tw_inv, tw_fwd, packed = self._kernel_tables()
        return h_kernels.ntt(x.contiguous(), tw_inv, tw_fwd, dif, dit,
                             None if scale is None else packed[scale])

    def dif_inverse(self, evals):
        """evals (natural order) -> coeffs (bit-reversed), includes 1/n
        scale. evals: [L, *batch, n] Montgomery form, one transform a row."""
        return self._transform(evals, True, False, "ninv")

    def dit_forward(self, coeffs_br):
        """coeffs (bit-reversed) -> evals (natural order)."""
        return self._transform(coeffs_br, False, True, None)

    def coset_evals_from_coeffs_br(self, coeffs_br):
        """coeffs (bitrev) -> evaluations on the coset shift*<w> (natural)."""
        return self._transform(coeffs_br, False, True, "shift")

    def coeffs_br_from_coset_evals(self, evals, from_mont: bool = False):
        """evaluations on coset (natural) -> coeffs (bitrev); with from_mont,
        as plain residues (F.from_mont of the result)."""
        return self._transform(evals, True, False, "ninv_shift_inv_plain"
                               if from_mont else "ninv_shift_inv")

    def coset_evals_from_evals(self, evals):
        """evaluations on the domain (natural) -> evaluations on the coset
        (natural): coset_evals_from_coeffs_br(dif_inverse(evals)), the DIF
        and DIT sharing K4's launch of the smallest spans."""
        return self._transform(evals, True, True, "ninv_shift")

"""Circle group over M31 and the circle FFT (Circle-STARK core primitive).

Ported from the JAX package's ``stark/circle.py``, with the same domain
ordering and twiddles:

  - circle C(M31): x^2 + y^2 = 1, a cyclic group of order 2^31
  - size-N standard coset: odd powers {G_{n+1}^(2i+1)}, closed under
    conjugation (x, y) -> (x, -y)
  - circle FFT: one y-fold layer, then log2(N)-1 x-fold layers through the
    doubling map pi(x) = 2x^2 - 1

Domain ordering: index i < N/2 holds G_{n+1}^(2i+1); index N/2 + i holds its
conjugate. At every x-level the +-x pairing is (i, m-1-i).

``interpolate`` and ``evaluate`` work on a batch of columns [C, N] (the
reference vmaps them); ``evaluate`` also takes [C, K] with K <= N, the
coefficients past K being zero. On a CUDA tensor the shape rule, decided
on N before any launch, is:

  - N <= 2^FFT_MAX_LOG (2^15 values, 128 KB a column): the whole transform
    is one K7b launch (ops/stark_kernels.circle_fft), each column held in
    shared memory;
  - larger N: one K7b launch per fold layer (ops/stark_kernels.circle_layer),
    through device memory.

On a CPU tensor each layer is ``layer_plain``, the reference's fold
(circle.py:103-135) on the same chunk-major layout. The twiddles are
computed on the host as in the reference and copied to the device once per
CircleFFT.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import stark_kernels
from .m31 import P31, m31_add, m31_mul, m31_sub

ORDER_LOG = 31     # |C(M31)| = 2^31
INV2 = pow(2, -1, P31)
PLAIN_COLUMNS = 4096   # columns per step of the plain versions (memory bound)


def _host_mul(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    return ((x1 * x2 - y1 * y2) % P31, (x1 * y2 + y1 * x2) % P31)


def _host_pow(p, k):
    result = (1, 0)
    addend = p
    while k:
        if k & 1:
            result = _host_mul(result, addend)
        addend = _host_mul(addend, addend)
        k >>= 1
    return result


@functools.lru_cache(maxsize=1)
def circle_generator():
    """A generator of the full 2^31 circle group (found programmatically)."""
    for x in range(2, 1000):
        # y^2 = 1 - x^2; p = 3 (mod 4), so a square root is v^((p+1)/4)
        v = (1 - x * x) % P31
        y = pow(v, (P31 + 1) // 4, P31)
        if y * y % P31 != v:
            continue
        g = (x, y)
        # order divides 2^31; generator iff g^(2^30) != identity
        if _host_pow(g, 1 << 30) != (1, 0):
            return g
    raise RuntimeError("no circle generator found")


def _inverses(vals: np.ndarray) -> np.ndarray:
    return np.array([pow(int(v), -1, P31) for v in vals], dtype=np.uint32)


class CircleFFT:
    """Precomputed domain + twiddles for a fixed power-of-two size N (host
    numpy), with device copies made at first use on each device."""

    def __init__(self, log_n: int):
        assert 2 <= log_n <= 30
        self.log_n = log_n
        self.n = n = 1 << log_n
        g_big = _host_pow(circle_generator(), 1 << (ORDER_LOG - (log_n + 1)))
        # first-half points: odd powers g_big^(2i+1)
        pts = []
        cur = g_big
        step = _host_mul(g_big, g_big)
        for _ in range(n // 2):
            pts.append(cur)
            cur = _host_mul(cur, step)
        xs = np.array([p[0] for p in pts], dtype=np.uint32)
        ys = np.array([p[1] for p in pts], dtype=np.uint32)
        self.domain_x = np.concatenate([xs, xs])
        self.domain_y = np.concatenate([ys, (P31 - ys) % P31])
        # per-level x twiddles (first half of each level's domain)
        self._x_levels = []
        cur_x = xs
        while len(cur_x) >= 2:
            self._x_levels.append(cur_x[: len(cur_x) // 2].copy())
            cur_x = (2 * cur_x[: len(cur_x) // 2].astype(np.uint64) ** 2 - 1) % P31
            cur_x = cur_x.astype(np.uint32)
        self._inv_y = _inverses(ys)
        self._inv_x_levels = [_inverses(lvl) for lvl in self._x_levels]
        self._tw = {}                  # device -> twiddle tensors

    def twiddles(self, device) -> dict:
        """{"y", "inv_y": [N/2], "x", "inv_x": per-level lists} as int32
        tensors on `device`, and circle_fft's packed twiddles "fft_interp",
        "fft_eval" [N]: the layer of width w at [N - 2w, N - w) (the
        y-layer first); interpolate's inverted and halved (made once per
        device)."""
        device = torch.device(device)
        if device not in self._tw:
            t = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)

            def packed(levels):
                out = np.zeros(self.n, dtype=np.uint64)
                out[:self.n - 1] = np.concatenate(levels)
                return out
            ys = self.domain_y[: self.n // 2]
            inv = packed([self._inv_y, *self._inv_x_levels]) * INV2 % P31
            self._tw[device] = {
                "y": t(ys), "inv_y": t(self._inv_y),
                "x": [t(lvl) for lvl in self._x_levels],
                "inv_x": [t(lvl) for lvl in self._inv_x_levels],
                "fft_interp": t(inv), "fft_eval": t(packed([ys, *self._x_levels]))}
        return self._tw[device]

    def _check(self, a: torch.Tensor, what: str, short: bool = False):
        if a.dim() != 2 or not (a.shape[1] <= self.n if short else a.shape[1] == self.n):
            want = f"[C, K <= {self.n}]" if short else f"[C, {self.n}]"
            raise ValueError(f"{what}: expected {want}, got {tuple(a.shape)}")

    def _zero_extend(self, a: torch.Tensor) -> torch.Tensor:
        if a.shape[1] == self.n:
            return a
        out = torch.zeros((a.shape[0], self.n), dtype=torch.int32, device=a.device)
        out[:, :a.shape[1]] = a
        return out

    # ---- transforms ----

    def interpolate(self, evals: torch.Tensor) -> torch.Tensor:
        """evals [C, N] on the domain -> coefficients int32 [C, N]: K7b on a
        CUDA tensor (one launch up to 2^FFT_MAX_LOG, else one a layer), the
        plain version on a CPU tensor."""
        self._check(evals, "interpolate")
        if evals.device.type == "cpu":
            return self.interpolate_plain(evals)
        return self._kernels(evals, True)

    def evaluate(self, coeffs: torch.Tensor) -> torch.Tensor:
        """coefficients [C, K] (K <= N; those past K are zero) ->
        evaluations int32 [C, N] on the domain: K7b on a CUDA tensor (one
        launch up to 2^FFT_MAX_LOG, reading the K coefficients, else one a
        layer), the plain version on a CPU tensor."""
        self._check(coeffs, "evaluate", short=True)
        if coeffs.device.type == "cpu":
            return self.evaluate_plain(coeffs)
        return self._kernels(coeffs, False)

    def interpolate_plain(self, evals: torch.Tensor) -> torch.Tensor:
        self._check(evals, "interpolate")
        return self._plain(evals, True)

    def evaluate_plain(self, coeffs: torch.Tensor) -> torch.Tensor:
        self._check(coeffs, "evaluate", short=True)
        return self._plain(self._zero_extend(coeffs.to(torch.int32)), False)

    def _kernels(self, x: torch.Tensor, interp: bool) -> torch.Tensor:
        """The transform through K7b by the shape rule: one circle_fft
        launch for N <= 2^FFT_MAX_LOG (evaluate reading only x's K
        columns of coefficients), else one circle_layer launch a layer."""
        x = x.to(torch.int32).contiguous()
        if self.log_n <= stark_kernels.FFT_MAX_LOG:
            tw = self.twiddles(x.device)["fft_interp" if interp else "fft_eval"]
            return stark_kernels.circle_fft(x, interp, self.log_n, tw)
        return self._transform(self._zero_extend(x), interp, stark_kernels.circle_layer)

    def _plain(self, x: torch.Tensor, interp: bool) -> torch.Tensor:
        """The transform by layer_plain, PLAIN_COLUMNS columns at a time."""
        return torch.cat([self._transform(x[i:i + PLAIN_COLUMNS], interp, layer_plain)
                          for i in range(0, x.shape[0], PLAIN_COLUMNS)]
                         or [x.to(torch.int32)])

    def _transform(self, x: torch.Tensor, interp: bool, layer) -> torch.Tensor:
        """interpolate (the y-fold, then the x-folds from the widest) or
        evaluate (the x-layers from the narrowest, then the y-layer) as log N
        calls of `layer` (circle_layer's signature)."""
        tw = self.twiddles(x.device)
        x = x.to(torch.int32).contiguous()
        if interp:
            x = layer(x, True, False, self.log_n - 1, tw["inv_y"])
            for k, inv_x in enumerate(tw["inv_x"]):
                x = layer(x, True, True, self.log_n - 2 - k, inv_x)
            return x
        for x_lvl in reversed(tw["x"]):
            x = layer(x, False, True, x_lvl.numel().bit_length() - 1, x_lvl)
        return layer(x, False, False, self.log_n - 1, tw["y"])


def layer_plain(src: torch.Tensor, interp: bool, rev: bool, log_w: int,
                tw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K7b: one fold layer of circle.py:103-135 over the rows
    of src [C, N], whose values are held chunk-major (chunk j of width w at
    [j * w, (j + 1) * w)), as the reference's [chunks, width] arrays are:

      interp, not rev: the y-fold   f0 = (a + b)/2, f1 = (a - b)/2 / y
      interp, rev:     an x-fold    lo, hi = g[:, :m/2], g[:, m/2:][::-1];
                                    [(lo + hi)/2; (lo - hi)/2 / x]
      not interp, rev: an x-layer   g0, g1 = g[:c], g[c:]; t = x g1;
                                    [g0 + t | (g0 - t)[::-1]]
      not interp, not rev: the y-layer  [f0 + y f1, f0 - y f1]

    at chunk width 2^log_w (the width of the twiddles tw). Returns int32."""
    C, N = src.shape
    half, w = N // 2, 1 << log_w
    x = src.to(torch.int64)
    t = tw.to(torch.int64)
    if interp:
        if rev:
            g = x.reshape(C, N // (2 * w), 2 * w)
            lo, hi = g[:, :, :w], g[:, :, w:].flip(2)
        else:
            lo, hi = x[:, :half], x[:, half:]
        g0 = m31_mul(m31_add(lo, hi), INV2)
        g1 = m31_mul(m31_mul(m31_sub(lo, hi), INV2), t)
        out = torch.cat([g0.reshape(C, half), g1.reshape(C, half)], dim=1)
    else:
        g0 = x[:, :half].reshape(C, half // w, w)
        prod = m31_mul(t, x[:, half:].reshape(C, half // w, w))
        lo, hi = m31_add(g0, prod), m31_sub(g0, prod)
        out = (torch.cat([lo, hi.flip(2)], dim=2).reshape(C, N) if rev else
               torch.cat([lo.reshape(C, half), hi.reshape(C, half)], dim=1))
    return out.to(torch.int32)

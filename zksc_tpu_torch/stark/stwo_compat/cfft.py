"""stwo's circle FFT, through the stark engine's ``circle.CircleFFT``.

The reference (``zksc_tpu/stark/stwo_compat/cfft.py``) folds numpy columns
in stwo's stored order (bit-reversed, fold siblings adjacent). The stark
engine's CircleFFT folds the same points in its own domain order and gives
the same coefficients, in the same order and with no scaling; only the rows
of the values differ. So here:

  interpolate: gather the stored rows into CircleFFT's domain order, then
               CircleFFT(log n).interpolate;
  evaluate:    CircleFFT(log_domain).evaluate of the m coefficients (the
               rest of the 2^log_domain are zero), then gather the rows
               back to stored order.

Both gathers come from one row map a log size (``row_map``), built from the
domain points: neither is a plain bit reversal. CircleFFT runs K7b on a
CUDA tensor and its plain version on a CPU tensor, so this module has no
plain version of its own. Unlike the reference's [rows, columns] arrays, the
tensors here are [columns, rows], the layout K7b takes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..circle import CircleFFT
from .circle import CanonicCoset


@functools.lru_cache(maxsize=32)
def fft(log_size: int) -> CircleFFT:
    return CircleFFT(log_size)


@functools.lru_cache(maxsize=32)
def row_map(log_size: int) -> np.ndarray:
    """int64 [2^log_size]: the stored position of CircleFFT's domain point
    j (the same point of CanonicCoset(log_size)'s circle domain)."""
    dom = CanonicCoset(log_size).circle_domain()
    stored = {dom.at_stored(s): s for s in range(1 << log_size)}
    f = fft(log_size)
    return np.array([stored[(int(x), int(y))]
                     for x, y in zip(f.domain_x, f.domain_y)], dtype=np.int64)


@functools.lru_cache(maxsize=64)
def _maps_on(log_size: int, device: torch.device) -> tuple:
    """(to domain order, to stored order) index tensors on `device`."""
    m = row_map(log_size)
    return (torch.from_numpy(m).to(device),
            torch.from_numpy(np.argsort(m)).to(device))


def interpolate(values: torch.Tensor) -> torch.Tensor:
    """values [C, n] in stored order -> coefficients int32 [C, n]."""
    log_size = values.shape[1].bit_length() - 1
    to_domain, _ = _maps_on(log_size, values.device)
    return fft(log_size).interpolate(values[:, to_domain])


def evaluate(coeffs: torch.Tensor, log_domain: int) -> torch.Tensor:
    """coefficients [C, m] (m <= 2^log_domain) -> values int32 [C,
    2^log_domain] on CanonicCoset(log_domain)'s circle domain, stored
    order."""
    _, to_stored = _maps_on(log_domain, coeffs.device)
    return fft(log_domain).evaluate(coeffs)[:, to_stored]


def lde(values: torch.Tensor, log_blowup: int = 1) -> torch.Tensor:
    """values [C, n] on CanonicCoset(log n) -> evaluations on the
    2^(log n + log_blowup) commitment domain (stored order)."""
    log_size = values.shape[1].bit_length() - 1
    return evaluate(interpolate(values), log_size + log_blowup)

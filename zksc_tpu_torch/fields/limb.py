"""Limb-decomposed modular arithmetic in PyTorch.

BN254 Fr/Fp elements (254 bits) are vectors of 16-bit limbs laid out
**limb-major**: a batch of shape ``batch`` is a tensor of shape
``(L, *batch)``, the same boundary layout as the JAX package's
``fields/limb.py``, so arrays compare limb for limb.

Storage is ``torch.int32``: every limb is below 2^16, so the sign bit never
matters and the CUDA kernels read the same bits as uint32. The arithmetic
here computes in ``int64`` internally, where lazily accumulated limbs
(partial products, segment sums) fit without overflow, and returns int32.

Multiplication is Montgomery (R = 2^(16 L) = 2^256). Every result is
canonical (in [0, p)), so any exact formulation yields the same limbs as
the reference: the borrow that the JAX code reads as ``d >> 31`` of a
wrapped uint32 is, in signed int64, the arithmetic shift ``d >> 16`` of a
negative limb difference.

These functions are plain tensor code: on the GPU they run as eager PyTorch
ops (the bucket-MSM point additions go through the hand-written kernels in
``ops/ec_kernels.py`` instead).
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

W = 16                      # bits per limb
MASK = (1 << W) - 1


def int_to_limbs(x: int, L: int) -> np.ndarray:
    """Python int -> np.uint32[L] little-endian 16-bit limbs."""
    assert 0 <= x < (1 << (W * L)), "value out of range for limb count"
    return np.array([(x >> (W * i)) & MASK for i in range(L)], dtype=np.uint32)


def ints_to_limb_array(vals: Sequence[int], L: int) -> np.ndarray:
    """Non-negative ints < 2^(16 L) -> np.int32[L, n] limb-major."""
    n = len(vals)
    if n == 0:
        return np.zeros((L, 0), dtype=np.int32)
    buf = b"".join(int(v).to_bytes(2 * L, "little") for v in vals)
    arr = np.frombuffer(buf, dtype="<u2").reshape(n, L).T
    return np.ascontiguousarray(arr.astype(np.int32))


def limb_array_to_ints(arr: np.ndarray) -> list:
    """np [L, n] limbs (< 2^16) -> list of n python ints."""
    L = arr.shape[0]
    flat = np.ascontiguousarray(arr.reshape(L, -1).T.astype("<u2"))
    raw = flat.tobytes()
    step = 2 * L
    return [int.from_bytes(raw[i:i + step], "little")
            for i in range(0, len(raw), step)]


def _propagate(T: torch.Tensor):
    """Exact carry/borrow propagation over the leading limb axis.

    T: int64 [K, *batch] with signed lazy limbs (|limb| < 2^62). Returns
    (limbs in [0, 2^16) as int64 [K, *batch], final signed carry): the
    value sum_k T[k] 2^(16k) equals limbs + carry * 2^(16K)."""
    outs = []
    c = None
    for k in range(T.shape[0]):
        s = T[k] if c is None else T[k] + c
        outs.append(s)
        c = s >> W                  # arithmetic shift: floor division
    return torch.stack(outs) & MASK, c


class LimbField:
    """Vectorized modular arithmetic over a fixed odd prime modulus.

    Elements are integer tensors of shape (L, *batch), normally in
    Montgomery form. The same class serves BN254 Fr and Fp."""

    def __init__(self, modulus: int, n_limbs: int | None = None,
                 name: str = "F"):
        self.p = modulus
        self.name = name
        if n_limbs is None:
            n_limbs = (modulus.bit_length() + W - 1) // W
        self.L = n_limbs
        R = 1 << (W * n_limbs)
        assert modulus < R
        self.R_int = R % modulus
        self.R2_int = (R * R) % modulus
        self.n0 = (-pow(modulus, -1, 1 << W)) % (1 << W)
        self.p_np = int_to_limbs(modulus, n_limbs)
        self._p_cache: dict = {}

    def _p_col(self, like: torch.Tensor) -> torch.Tensor:
        """p's limbs as int64 [L, 1, ..., 1] on like's device."""
        key = (like.device, like.dim())
        t = self._p_cache.get(key)
        if t is None:
            t = torch.as_tensor(self.p_np.astype(np.int64), device=like.device)
            t = t.reshape((self.L,) + (1,) * (like.dim() - 1))
            self._p_cache[key] = t
        return t

    # ---------------- host conversions ----------------

    def to_device(self, values: Sequence[int] | int, mont: bool = True,
                  device=None) -> torch.Tensor:
        """Python ints -> (L, n) int32 tensor (Montgomery form by default)."""
        if isinstance(values, int):
            values = [values]
        vals = [int(v) % self.p for v in values]
        if mont:
            vals = [(v << (W * self.L)) % self.p for v in vals]
        return torch.from_numpy(ints_to_limb_array(vals, self.L)).to(device)

    def from_device(self, x: torch.Tensor, mont: bool = True) -> list:
        """(L, *batch) tensor -> flat list of python ints (batch row-major)."""
        vals = limb_array_to_ints(x.detach().cpu().numpy())
        if mont:
            rinv = pow(self.R_int, -1, self.p)
            return [(v * rinv) % self.p for v in vals]
        return [v % self.p for v in vals]

    # ---------------- shape helpers ----------------

    def zeros(self, batch: tuple, device=None) -> torch.Tensor:
        return torch.zeros((self.L, *batch), dtype=torch.int32, device=device)

    def broadcast_const(self, value: int, batch: tuple, mont: bool = True,
                        device=None) -> torch.Tensor:
        v = value % self.p
        if mont:
            v = (v << (W * self.L)) % self.p
        limbs = torch.as_tensor(int_to_limbs(v, self.L).astype(np.int32),
                                device=device)
        return limbs.reshape((self.L,) + (1,) * len(batch)).expand(
            (self.L, *batch)).contiguous()

    # ---------------- core arithmetic ----------------

    def _cond_sub_p_ext(self, t: torch.Tensor, hi=None) -> torch.Tensor:
        """t (int64 canonical limbs, value < 2p, plus optional extra high
        limb `hi` >= 0) -> t mod p as int32."""
        d, borrow = _propagate(t - self._p_col(t))
        ge = borrow == 0
        if hi is not None:
            ge = ge | (hi > 0)
        return torch.where(ge.unsqueeze(0), d, t).to(torch.int32)

    def add(self, a, b):
        """(a + b) mod p, inputs/outputs (L, *batch) reduced (< p)."""
        t, c = _propagate(a.to(torch.int64) + b.to(torch.int64))
        return self._cond_sub_p_ext(t, c)

    def sub(self, a, b):
        """(a - b) mod p."""
        t, borrow = _propagate(a.to(torch.int64) - b.to(torch.int64))
        back = self._p_col(t) * (borrow < 0).unsqueeze(0)
        out, _ = _propagate(t + back)
        return out.to(torch.int32)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def _mont_reduce(self, T: torch.Tensor) -> torch.Tensor:
        """Montgomery-reduce lazy int64 limbs T [>= 2L, *batch] (value < pR,
        limbs < 2^40) in place: returns T * R^-1 mod p as int32 [L, *batch]."""
        L = self.L
        p = self._p_col(T)
        for i in range(L):
            m = (T[i] * self.n0) & MASK      # low 16 bits of limb i are exact
            T[i:i + L].addcmul_(m.unsqueeze(0), p)
            T[i + 1] += T[i] >> W            # retire limb i (now = 0 mod 2^16)
        res, c = _propagate(T[L:2 * L])
        hi = c if T.shape[0] == 2 * L else T[2 * L:].sum(0) + c
        return self._cond_sub_p_ext(res, hi)

    def mont_mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p, elementwise with broadcasting
        over the batch axes."""
        a = a.to(torch.int64)
        b = b.to(torch.int64)
        L = self.L
        a, b = torch.broadcast_tensors(a, b)
        T = torch.zeros((2 * L, *a.shape[1:]), dtype=torch.int64,
                        device=a.device)
        for i in range(L):                   # schoolbook, lazy limbs < 2^36
            T[i:i + L].addcmul_(a[i].unsqueeze(0), b)
        return self._mont_reduce(T)

    def mont_sqr(self, a):
        return self.mont_mul(a, a)

    def mont_reduce_wide(self, t_limbs: list):
        """Montgomery-reduce a wide value T (list of >= L limbs, each
        < 2^16): returns T * R^-1 mod p as (L, *batch). Requires T < p*R."""
        L = self.L
        n_ext = len(t_limbs)
        assert n_ext <= 2 * L + 1
        T = torch.stack([t.to(torch.int64) for t in t_limbs])
        if n_ext < 2 * L:
            T = torch.cat([T, T.new_zeros((2 * L - n_ext, *T.shape[1:]))])
        return self._mont_reduce(T)

    def normalize_u32_limbs(self, raw: list):
        """Carry-propagate limbs that may each hold values up to 2^32 (e.g.
        after a segment-sum accumulation) into canonical 16-bit limbs.
        Returns a longer limb list (len + 2) with each limb < 2^16."""
        T = torch.stack([r.to(torch.int64) for r in raw])
        T = torch.cat([T, T.new_zeros((2, *T.shape[1:]))])
        out, _ = _propagate(T)
        return [out[j].to(torch.int32) for j in range(out.shape[0])]

    def mul_const(self, a, k: int):
        """a * k mod p for a host-known int k; a in Montgomery form, result
        too."""
        return self.mont_mul(a, self.broadcast_const(k, a.shape[1:],
                                                     device=a.device))

    def mont_pow(self, a, e: int):
        """a^e (Montgomery in, Montgomery out) for a host-known exponent e:
        MSB-first square and multiply from one, as the reference's
        fori_loop; a zero bit skips its multiply, which leaves the same
        canonical limbs (0^0 = 1)."""
        nbits = max(e.bit_length(), 1)
        res = self.broadcast_const(1, a.shape[1:], device=a.device)
        for i in range(nbits):
            res = self.mont_mul(res, res)
            if (e >> (nbits - 1 - i)) & 1:
                res = self.mont_mul(res, a)
        return res

    def inv(self, a):
        """Batched modular inverse via Fermat (a^(p-2)); Montgomery in/out.
        0 -> 0."""
        return self.mont_pow(a, self.p - 2)

    def eq(self, a, b):
        return (a == b).all(0)

    def is_zero(self, a):
        return (a == 0).all(0)

    def select(self, cond, a, b):
        """where(cond, a, b) broadcasting cond over the limb axis."""
        return torch.where(cond.unsqueeze(0), a, b)

    @functools.cached_property
    def one_limbs(self) -> np.ndarray:
        return int_to_limbs(self.R_int, self.L)           # 1 in Montgomery form

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.R2_int, self.L)

    def to_mont(self, a):
        """Convert non-Montgomery residues (< p) to Montgomery form."""
        r2 = torch.as_tensor(self.r2_limbs.astype(np.int64), device=a.device)
        return self.mont_mul(a, r2.reshape((self.L,) + (1,) * (a.dim() - 1)))

    def from_mont(self, a):
        """Montgomery -> plain residues: multiply by 1 (Montgomery reduce)."""
        return self.mont_reduce_wide([a[j] for j in range(self.L)])


# ---------------- BN254 constants ----------------
BN254_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN254_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

Fp = LimbField(BN254_P, 16, name="BN254.Fp")
Fr = LimbField(BN254_R, 16, name="BN254.Fr")

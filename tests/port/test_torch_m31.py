"""Port vs reference: M31, CM31 and QM31 arithmetic (zksc_tpu_torch.stark.m31,
int64 tensors) against zksc_tpu.stark.m31 (uint32 arrays), value for value,
on a few hundred values including 0, 1 and p - 1."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksc_tpu.stark import m31 as jm
from zksc_tpu_torch.stark import m31 as tm

P = tm.P31


def _vals(seed, n=300):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, P, n, dtype=np.int64)
    v[:6] = [0, 1, P - 1, 0, P - 1, 1]
    return v


def _pair(seed):
    a, b = _vals(seed), _vals(seed + 100)
    b[:6] = [0, P - 1, P - 1, 1, 1, 0]     # every corner pairing
    return a, b


def _j(v):
    return jnp.asarray(v.astype(np.uint32))


def _t(v):
    return torch.from_numpy(v.astype(np.int64))


def _eq(ref, got):
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64), got.numpy())


def test_constant():
    assert tm.P31 == jm.P31


@pytest.mark.parametrize("op", ["m31_add", "m31_sub", "m31_mul"])
def test_m31_binary(op):
    a, b = _pair(1)
    _eq(getattr(jm, op)(_j(a), _j(b)), getattr(tm, op)(_t(a), _t(b)))


def test_m31_neg_pow_inv():
    a = _vals(2)
    _eq(jm.m31_neg(_j(a)), tm.m31_neg(_t(a)))
    for e in (0, 1, 2, 5, 1 << 20, P - 3):
        _eq(jm.m31_pow(_j(a), e), tm.m31_pow(_t(a), e))
    nz = a[a != 0][:40]
    _eq(jm.m31_inv(_j(nz)), tm.m31_inv(_t(nz)))


def _ext(seed, width):
    return tuple(_vals(seed + i, 120) for i in range(width))


def _jc(x):
    return (_j(x[0]), _j(x[1]))


def _tc(x):
    return (_t(x[0]), _t(x[1]))


def _eq_tuple(ref, got):
    if isinstance(got, tuple):
        for r, g in zip(ref, got):
            _eq_tuple(r, g)
    else:
        _eq(ref, got)


@pytest.mark.parametrize("op", ["cm31_add", "cm31_sub", "cm31_mul"])
def test_cm31_binary(op):
    a, b = _ext(3, 2), _ext(13, 2)
    _eq_tuple(getattr(jm, op)(_jc(a), _jc(b)), getattr(tm, op)(_tc(a), _tc(b)))


def test_cm31_neg_inv():
    a = _ext(5, 2)
    _eq_tuple(jm.cm31_neg(_jc(a)), tm.cm31_neg(_tc(a)))
    keep = (a[0] != 0) | (a[1] != 0)
    nz = (a[0][keep][:40], a[1][keep][:40])
    _eq_tuple(jm.cm31_inv(_jc(nz)), tm.cm31_inv(_tc(nz)))


def _jq(x):
    return ((_j(x[0]), _j(x[1])), (_j(x[2]), _j(x[3])))


def _tq(x):
    return ((_t(x[0]), _t(x[1])), (_t(x[2]), _t(x[3])))


@pytest.mark.parametrize("op", ["qm31_add", "qm31_sub", "qm31_mul"])
def test_qm31_binary(op):
    a, b = _ext(7, 4), _ext(17, 4)
    _eq_tuple(getattr(jm, op)(_jq(a), _jq(b)), getattr(tm, op)(_tq(a), _tq(b)))


def test_qm31_inv():
    a = tuple(x[:40] for x in _ext(9, 4))
    a[0][0] = 1                        # 1 + 0 u (and p - 1 corners above)
    for x in a[1:]:
        x[0] = 0
    _eq_tuple(jm.qm31_inv(_jq(a)), tm.qm31_inv(_tq(a)))

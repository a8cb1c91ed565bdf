"""Port vs reference: BN254 limb arithmetic (zksc_tpu_torch.fields.limb vs
zksc_tpu.fields.limb), exact limb equality on 64 lanes per field, including
0, 1, p-1 and values >= 2^253. The port runs its plain PyTorch path on the
CPU."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksc_tpu.fields import limb as jl
from zksc_tpu_torch.fields import limb as tl

FIELDS = ("Fp", "Fr")


def _values(p: int, seed: int) -> list:
    rng = random.Random(seed)
    edge = [0, 1, 2, p - 1, p - 2, 1 << 253, (1 << 253) + 12345, p // 2]
    return edge + [rng.randrange(p) for _ in range(64 - len(edge))]


@pytest.fixture(scope="module", params=FIELDS)
def fields(request):
    JF, TF = getattr(jl, request.param), getattr(tl, request.param)
    a_int = _values(JF.p, 1)
    b_int = list(reversed(_values(JF.p, 2)))
    a = np.asarray(JF.to_device(a_int))
    b = np.asarray(JF.to_device(b_int))
    return JF, TF, a_int, b_int, a, b


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _eq(ref, got):
    ref = np.asarray(ref).astype(np.int64)
    got = got.numpy().astype(np.int64)
    assert ref.shape == got.shape
    np.testing.assert_array_equal(ref, got)


def test_to_from_device(fields):
    JF, TF, a_int, _, a, _ = fields
    got = TF.to_device(a_int)
    assert got.dtype == torch.int32
    _eq(a, got)
    _eq(JF.to_device(a_int, mont=False), TF.to_device(a_int, mont=False))
    assert TF.from_device(got) == JF.from_device(jnp.asarray(a)) == \
        [v % JF.p for v in a_int]
    assert TF.from_device(got, mont=False) == JF.from_device(jnp.asarray(a),
                                                            mont=False)


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops(fields, op):
    JF, TF, _, _, a, b = fields
    _eq(getattr(JF, op)(jnp.asarray(a), jnp.asarray(b)),
        getattr(TF, op)(_t(a), _t(b)))


@pytest.mark.parametrize("op", ["neg", "to_mont", "from_mont"])
def test_unary_ops(fields, op):
    JF, TF, _, _, a, _ = fields
    _eq(getattr(JF, op)(jnp.asarray(a)), getattr(TF, op)(_t(a)))


def test_mont_reduce_wide_and_normalize(fields):
    """Wide values from lazy u32 limb sums (the matvec's segment sums):
    normalize, then Montgomery-reduce."""
    JF, TF, _, _, a, b = fields
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 1 << 32, size=(16, 64), dtype=np.uint64)
    raw[:, 0] = 0
    raw[:, 1] = (1 << 32) - 1
    raw[15] >>= 20                      # keep the value < p * R
    ref_norm = JF.normalize_u32_limbs(
        [jnp.asarray(raw[j].astype(np.uint32)) for j in range(16)])
    got_norm = TF.normalize_u32_limbs(
        [torch.from_numpy(raw[j].astype(np.int64)) for j in range(16)])
    assert len(ref_norm) == len(got_norm) == 18
    for r, g in zip(ref_norm, got_norm):
        _eq(r, g)
    _eq(JF.mont_reduce_wide(ref_norm), TF.mont_reduce_wide(got_norm))
    # a full product as 32 wide limbs
    wide = [jnp.asarray(x) for x in np.concatenate([a, b[:16]])]
    _eq(JF.mont_reduce_wide(wide),
        TF.mont_reduce_wide([_t(x) for x in np.concatenate([a, b[:16]])]))


def test_predicates_and_consts(fields):
    JF, TF, _, _, a, b = fields
    ta, tb = _t(a), _t(b)
    np.testing.assert_array_equal(np.asarray(JF.is_zero(jnp.asarray(a))),
                                  TF.is_zero(ta).numpy())
    cond = np.arange(64) % 3 == 0
    _eq(JF.select(jnp.asarray(cond), jnp.asarray(a), jnp.asarray(b)),
        TF.select(torch.from_numpy(cond), ta, tb))
    for v, mont in ((7, True), (JF.p - 1, False), (1 << 253, True)):
        _eq(JF.broadcast_const(v, (5,), mont=mont),
            TF.broadcast_const(v, (5,), mont=mont))
    np.testing.assert_array_equal(JF.r2_limbs, TF.r2_limbs)

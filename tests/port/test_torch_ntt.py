"""Port vs reference: the Fr NTT of the Groth16 quotient (n = 64), all four
transforms and their tables, exact limb equality with zksc_tpu.ops.ntt."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksc_tpu.fields.limb import Fr as JFr
from zksc_tpu.ops import ntt as jntt
from zksc_tpu_torch.fields.limb import Fr
from zksc_tpu_torch.ops import ntt as tntt

N = 64


@pytest.fixture(scope="module")
def contexts():
    rng = random.Random(21)
    vals = [rng.randrange(JFr.p) for _ in range(N)]
    vals[0], vals[1] = 0, JFr.p - 1
    x = np.asarray(JFr.to_device(vals))
    return jntt.NTTContext(JFr, N), tntt.NTTContext(Fr, N), x


def _eq(ref, got):
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  got.numpy().astype(np.int64))


def test_tables(contexts):
    jc, tc, _ = contexts
    assert tc.w == jc.w and tc.n_inv == jc.n_inv and tc.shift == jc.shift
    assert tc.z_coset_int == jc.z_coset_int
    np.testing.assert_array_equal(tc.bitrev, jc.bitrev)
    assert tntt.find_2adic_root(Fr, 1 << 16) == jntt.find_2adic_root(JFr, 1 << 16)
    _eq(jc.shift_pows_br, tc.shift_pows_br)
    _eq(jc.shift_inv_pows_br, tc.shift_inv_pows_br)
    for length in jc._tw_fwd:
        _eq(jc._tw_fwd[length], tc._tw_fwd[length])
        _eq(jc._tw_inv[length], tc._tw_inv[length])


@pytest.mark.parametrize("name", ["dif_inverse", "dit_forward",
                                  "coset_evals_from_coeffs_br",
                                  "coeffs_br_from_coset_evals"])
def test_transforms(contexts, name):
    jc, tc, x = contexts
    ref = getattr(jc, name)(jnp.asarray(x))
    got = getattr(tc, name)(torch.from_numpy(x.astype(np.int32)))
    assert got.dtype == torch.int32
    _eq(ref, got)

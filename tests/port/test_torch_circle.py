"""Port vs reference: the circle FFT (zksc_tpu_torch.stark.circle, the plain
version K7b is held to on the card): the generator, domain and twiddles,
and interpolate / evaluate over a batch of columns equal to
zksc_tpu.stark.circle.CircleFFT (vmapped), with the round trip."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksc_tpu.stark import circle as jc
from zksc_tpu_torch.ops import stark_kernels
from zksc_tpu_torch.stark import circle as tc


@pytest.mark.parametrize("log_n", [3, 5, 8])
def test_domain_and_twiddles(log_n):
    ref, got = jc.CircleFFT(log_n), tc.CircleFFT(log_n)
    assert tc.circle_generator() == jc.circle_generator()
    np.testing.assert_array_equal(got.domain_x, ref.domain_x)
    np.testing.assert_array_equal(got.domain_y, ref.domain_y)
    assert len(got._x_levels) == len(ref._x_levels) == log_n - 1
    for a, b in zip(got._x_levels, ref._x_levels):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got._inv_x_levels, ref._inv_x_levels):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(got._inv_y, np.asarray(ref._inv_y))
    tw = got.twiddles("cpu")
    np.testing.assert_array_equal(tw["y"].numpy(), ref.domain_y[: 1 << (log_n - 1)])


@pytest.mark.parametrize("log_n", [3, 5, 8])
def test_transforms_match_jax(log_n):
    """4 columns (0, 1 and p - 1 among the values): interpolate, evaluate
    and the round trip."""
    ref, got = jc.CircleFFT(log_n), tc.CircleFFT(log_n)
    x = np.random.default_rng(log_n).integers(0, tc.P31, (4, 1 << log_n),
                                              dtype=np.int64)
    x[0, :3] = [0, 1, tc.P31 - 1]
    xt = torch.from_numpy(x.astype(np.int32))
    xj = jnp.asarray(x.astype(np.uint32))
    coeffs = got.interpolate(xt)
    np.testing.assert_array_equal(coeffs.numpy().astype(np.uint32),
                                  np.asarray(jax.vmap(ref.interpolate)(xj)))
    evals = got.evaluate(xt)
    np.testing.assert_array_equal(evals.numpy().astype(np.uint32),
                                  np.asarray(jax.vmap(ref.evaluate)(xj)))
    assert torch.equal(got.evaluate(coeffs), xt)


def test_layer_plain_forms():
    """One y-fold / x-fold / x-layer / y-layer of layer_plain, against the
    reference's array form on a single column (N = 8)."""
    P, inv2 = tc.P31, tc.INV2
    rng = np.random.default_rng(4)
    g = rng.integers(0, P, 8)
    tw4, tw2 = rng.integers(0, P, 4), rng.integers(0, P, 2)
    x = torch.from_numpy(g.astype(np.int32))[None]
    a, b = g[:4], g[4:]
    want = np.concatenate([(a + b) * inv2 % P, (a - b) % P * inv2 % P * tw4 % P])
    got = tc.layer_plain(x, True, False, 2, torch.from_numpy(tw4.astype(np.int32)))
    np.testing.assert_array_equal(got[0].numpy(), want)
    m = g.reshape(2, 4)                              # chunks of width 4
    lo, hi = m[:, :2], m[:, 2:][:, ::-1]
    want = np.concatenate([((lo + hi) * inv2 % P).ravel(),
                           ((lo - hi) % P * inv2 % P * tw2 % P).ravel()])
    got = tc.layer_plain(x, True, True, 1, torch.from_numpy(tw2.astype(np.int32)))
    np.testing.assert_array_equal(got[0].numpy(), want)
    g0, g1 = g[:4].reshape(2, 2), g[4:].reshape(2, 2)
    t = tw2 * g1 % P
    want = np.concatenate([(g0 + t) % P, ((g0 - t) % P)[:, ::-1]], axis=1).ravel()
    got = tc.layer_plain(x, False, True, 1, torch.from_numpy(tw2.astype(np.int32)))
    np.testing.assert_array_equal(got[0].numpy(), want)
    t = tw4 * g[4:] % P
    want = np.concatenate([(g[:4] + t) % P, (g[:4] - t) % P])
    got = tc.layer_plain(x, False, False, 2, torch.from_numpy(tw4.astype(np.int32)))
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_kernel_wrapper_refuses_cpu_tensors():
    fft = tc.CircleFFT(3)
    with pytest.raises(ValueError, match="CUDA"):
        stark_kernels.circle_layer(torch.zeros((1, 8), dtype=torch.int32),
                                   True, False, 2, fft.twiddles("cpu")["inv_y"])


@pytest.mark.parametrize("log_n, log_m, n_blinded", [(3, 6, 2), (4, 7, 0)])
def test_lde_short_block_matches_jax(log_n, log_m, n_blinded, monkeypatch):
    """The stark prover's _lde evaluates from a [rows + 1, K] coefficient
    block (K = N + ZK_COEFFS rounded up to a multiple of 4 with blinding, N
    without) instead of a zero-filled [rows + 1, M] one: its values equal
    the JAX package's interpolate, then evaluate of the [rows, M] block
    with the blinding coefficients at [N, N + ZK_COEFFS), on the same
    seeded columns; the last row is zero."""
    from zksc_tpu_torch.stark import prover as tp
    n, m, zk = 1 << log_n, 1 << log_m, tp.ZK_COEFFS
    rng = np.random.default_rng(10 + log_n)
    cols = rng.integers(0, tc.P31, (5, n)).astype(np.uint32)
    blind = rng.integers(0, 1 << 32, (n_blinded, zk), dtype=np.uint64).astype(np.uint32)
    fft_n, fft_m = tc.CircleFFT(log_n), tc.CircleFFT(log_m)
    shapes, evaluate = [], fft_m.evaluate
    monkeypatch.setattr(fft_m, "evaluate",
                        lambda c: shapes.append(tuple(c.shape)) or evaluate(c))
    got = tp._lde(fft_n, fft_m, cols, n_blinded, blind, "cpu")
    assert shapes == [(6, -(-(n + zk) // 4) * 4 if n_blinded else n)]
    jn, jm = jc.CircleFFT(log_n), jc.CircleFFT(log_m)
    cm = np.zeros((5, m), dtype=np.uint32)
    cm[:, :n] = np.asarray(jax.vmap(jn.interpolate)(jnp.asarray(cols)))
    cm[:n_blinded, n:n + zk] = blind % tc.P31
    want = np.asarray(jax.vmap(jm.evaluate)(jnp.asarray(cm)))
    np.testing.assert_array_equal(got[:5].numpy().astype(np.uint32), want)
    assert not got[5].any()


def test_evaluate_short_block_matches_jax():
    """CircleFFT.evaluate of [C, K < N] coefficients (the rest zero) equals
    the JAX package's evaluate of the zero-extended [C, N] block."""
    ref, got = jc.CircleFFT(6), tc.CircleFFT(6)
    x = np.random.default_rng(6).integers(0, tc.P31, (3, 20)).astype(np.uint32)
    full = np.zeros((3, 64), dtype=np.uint32)
    full[:, :20] = x
    np.testing.assert_array_equal(
        got.evaluate(torch.from_numpy(x.astype(np.int32))).numpy().astype(np.uint32),
        np.asarray(jax.vmap(ref.evaluate)(jnp.asarray(full))))

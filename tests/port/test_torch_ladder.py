"""Port vs reference: the double-and-add ladders (ops/ec.py:
msm_double_and_add, scale_points, the reducers) and the plain version of
the ladder kernel K3 (ops/msm_kernels.py), exact.

G1: the port's plain msm_double_and_add equals the JAX package's limb for
limb (16 lanes, 32-bit scalars, a zero and a one scalar, an identity lane),
and the per-lane ladders of the JAX function's body (_msm_step_jit, the
step its CPU path loops) equal K3's plain per-lane ladder limb for limb.
K3's plain ladder reduced over all lanes is the function msm_g1_pallas
computes; it equals the JAX msm_double_and_add as an affine point. The Pallas kernel body
itself costs 70 s of XLA:CPU in interpret mode, the JAX G2 ladder 90 s and
the JAX G2 scale 75 s (tools/time_jax_oracles.py ladder), so G2, the
proof-batched ladders and the shared-scalar scale are held to the JAX
package's host arithmetic (curve/bn254_host) instead. On the CPU the kernel
wrapper takes its plain version; chip_smoke.py holds the kernel to it on the
card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from zksc_tpu.curve import bn254_host as host
from zksc_tpu.fields.limb import Fp as JFp, Fr as JFr
from zksc_tpu.ops import ec as jec
from zksc_tpu_torch.fields.limb import Fp, Fr
from zksc_tpu_torch.ops import ec as tec
from zksc_tpu_torch.ops import msm_kernels

N_BITS = 32


def _points(g2: bool, n: int, seed: int) -> list:
    """Host affine points k_i * G from a numpy seed; lane 2 the identity."""
    rs = np.random.RandomState(seed)
    gen, mul = (host.G2_GEN, host.g2_mul) if g2 else (host.G1_GEN, host.g1_mul)
    pts = [mul(gen, int(rs.randint(1, 2**62))) for _ in range(n)]
    pts[2] = None
    return pts


def _scalars(n: int, seed: int, bits: int = N_BITS) -> list:
    rs = np.random.RandomState(seed)
    s = [int(rs.randint(0, 2**31)) << (bits - 31) | int(rs.randint(0, 2**31))
         for _ in range(n)]
    s[0], s[1] = 0, 1
    return [v % (1 << bits) for v in s]


def _to_dev(pts: list, g2: bool):
    conv = tec.g2_points_to_device if g2 else tec.g1_points_to_device
    return conv(Fp, pts, device="cpu")


def _affine(P, g2: bool) -> list:
    conv = tec.g2_jac_to_host_affine if g2 else tec.g1_jac_to_host_affine
    return conv(Fp, P, host.P)


def _host_msm(pts, scalars, g2: bool):
    mul, add = (host.g2_mul, host.g2_add) if g2 else (host.g1_mul, host.g1_add)
    acc = None
    for p, s in zip(pts, scalars):
        if p is not None and s:
            acc = add(acc, mul(p, s))
    return acc


def _bits(scalars: list, n_bits: int = N_BITS):
    return tec.scalars_to_bits(Fr, Fr.to_device(scalars, mont=False), n_bits)


def test_g1_ladders_match_jax():
    pts, sc = _points(False, 16, 1), _scalars(16, 2)
    jP = jec.g1_points_to_device(JFp, pts)
    jbits = jec.scalars_to_bits(JFr, JFr.to_device(sc, mont=False), N_BITS)
    tP, tbits = _to_dev(pts, False), _bits(sc)
    np.testing.assert_array_equal(np.asarray(jbits).astype(np.int64),
                                  tbits.numpy())
    # the reduced MSM, limb for limb (same halving order)
    ref = jec.msm_double_and_add(jec.G1_OPS, jP, jbits, N_BITS)
    got = tec.msm_double_and_add(tec.G1_OPS, tP, tbits, N_BITS)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64),
                                      g.numpy().astype(np.int64))
    # per lane: the JAX body step by step vs K3's plain ladder
    acc = jec.jac_identity_batch(jec.G1_OPS, (16,))
    for k in range(N_BITS - 1, -1, -1):
        acc = jec._msm_step_jit(jec.G1_OPS, acc, jP, jbits[k])
    lanes = msm_kernels.ladder(tec.G1_OPS, tP, tbits, N_BITS)
    for r, g in zip(acc, lanes):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64),
                                      g.numpy().astype(np.int64))
    # K3's plain MSM: the same point
    want = _host_msm(pts, sc, False)
    msm = msm_kernels.ladder_plain(tec.G1_OPS, tP, tbits, N_BITS, seg=16)
    assert _affine(msm, False) == [want]
    assert jec.g1_jac_to_host_affine(JFp, ref, host.P) == [want]


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_ladders_match_host(g2):
    """msm_double_and_add with k = 2 scalar sets, and K3's plain version
    unreduced and reduced over segments, against host scalar products."""
    fops = tec.G2_OPS if g2 else tec.G1_OPS
    pts = _points(g2, 8, 3 + g2)
    s0, s1 = _scalars(8, 5), _scalars(8, 6)
    P = _to_dev(pts, g2)
    bits2 = torch.stack([_bits(s0), _bits(s1)], dim=1)       # [n_bits, 2, 8]
    got = _affine(tec.msm_double_and_add(fops, P, bits2, N_BITS), g2)
    assert got == [_host_msm(pts, s0, g2), _host_msm(pts, s1, g2)]
    lanes = msm_kernels.ladder(fops, P, _bits(s0), N_BITS)
    mul = host.g2_mul if g2 else host.g1_mul
    assert _affine(lanes, g2) == [None if p is None or not s else mul(p, s)
                                  for p, s in zip(pts, s0)]
    seg4 = msm_kernels.ladder(fops, P, _bits(s0), N_BITS, seg=4)
    assert _affine(seg4, g2) == [_host_msm(pts[:4], s0[:4], g2),
                                 _host_msm(pts[4:], s0[4:], g2)]


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_scale_points_matches_host(g2):
    fops = tec.G2_OPS if g2 else tec.G1_OPS
    pts = _points(g2, 4, 7 + g2)
    s = 0xDEADBEEF12345678
    got = tec.scale_points(fops, _to_dev(pts, g2), s, n_bits=64)
    mul = host.g2_mul if g2 else host.g1_mul
    assert _affine(got, g2) == [None if p is None else mul(p, s) for p in pts]
    # K3's shared-bit mode is the same ladder
    bits = torch.tensor([(s >> i) & 1 for i in range(64)], dtype=torch.int32)
    same = msm_kernels.ladder(fops, _to_dev(pts, g2), bits, 64)
    for a, b in zip(got, same):
        assert torch.equal(a.to(torch.int32), b)


def test_grouped_reduce_levels(monkeypatch):
    """K3 reduces a segment longer than its group in levels: with the group
    cut to 4 lanes, a 16-lane segment takes two levels, which give the same
    point as one halving tree over the segment (another order), and with a
    group of at least the segment the very same limbs."""
    pts = _points(False, 16, 9)
    P = _to_dev(pts, False)
    tree = tec.jac_tree_reduce(tec.G1_OPS, P)
    assert _affine(tree, False) == [_host_msm(pts, [1] * 16, False)]
    same = msm_kernels._grouped_reduce(tec.G1_OPS, P, 16)
    for a, b in zip(tree, same):
        assert torch.equal(a, b)
    monkeypatch.setattr(msm_kernels, "GROUP", 4)
    two_level = msm_kernels._grouped_reduce(tec.G1_OPS, P, 16)
    assert _affine(two_level, False) == _affine(tree, False)
    halves = tec._segment_reduce(tec.G1_OPS, P, 8)
    assert _affine(halves, False) == [_host_msm(pts[:8], [1] * 8, False),
                                      _host_msm(pts[8:], [1] * 8, False)]

"""Port vs reference: the AES-CTR LogUp AIR and its composition.

The port's copy of aes_air (layout, trace, public columns, sigma, cum
column) equals the JAX package's; the port's interaction trace (the QM31
inverses on PyTorch ops) equals the reference's _interaction; and
_composition_plain (what K7d is held to on the card) equals the
reference's jitted _composition at the 80-byte chunk's shape (R x M =
8,589 x 2,048) on random values and challenges, for both key sizes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksc_tpu.stark import aes_air as jair
from zksc_tpu.stark import aes_prover as jp
from zksc_tpu_torch.ops import stark_kernels
from zksc_tpu_torch.ops.ciphers import aes_ctr_encrypt
from zksc_tpu_torch.stark import aes_air
from zksc_tpu_torch.stark import aes_prover as tp

P31 = (1 << 31) - 1
NONCE = bytes(range(12))
COUNTER0 = 2


pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def _flatten(groups, prefix=""):
    for k, v in sorted(groups.items()):
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield prefix + k, np.asarray(v)


@pytest.mark.parametrize("key_size", [16, 32])
def test_layout_matches_reference(key_size):
    n1, n2, groups = aes_air.layout(key_size)
    rn1, rn2, rgroups = jair.layout(key_size)
    assert (n1, n2) == (rn1, rn2)
    ours, theirs = dict(_flatten(groups)), dict(_flatten(rgroups))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert tp.n_constraints(key_size) == jp.n_constraints(key_size)
    assert aes_air.N_PUB == jair.N_PUB


def _rows(key, n_blocks, rows):
    rng = np.random.default_rng(len(key) + n_blocks)
    pt = rng.integers(0, 256, 16 * n_blocks, dtype=np.uint8).tobytes()
    ct = aes_ctr_encrypt(key, NONCE, COUNTER0, pt)
    pad = aes_ctr_encrypt(key, NONCE, COUNTER0 + n_blocks,
                          bytes(16 * (rows - n_blocks)))
    pt_rows = np.frombuffer(pt + pad, dtype=np.uint8).reshape(rows, 16)
    ct_rows = np.zeros((rows, 16), dtype=np.uint8)
    ct_rows[:n_blocks] = np.frombuffer(ct, dtype=np.uint8).reshape(-1, 16)
    return pt_rows, ct_rows


@pytest.mark.parametrize("key_size", [16, 32])
def test_trace_public_and_interaction_match_reference(key_size):
    """generate_trace, public_matrix, and the phase-2 trace (lookup
    fractions, table fraction, cum column) at 256 rows of 5 real blocks."""
    key = bytes(range(7, 7 + key_size))
    rows = 256
    pt_rows, ct_rows = _rows(key, 5, rows)
    got = aes_air.generate_trace(key, NONCE, COUNTER0, pt_rows, ct_rows)
    want = jair.generate_trace(key, NONCE, COUNTER0, pt_rows, ct_rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pub = aes_air.public_matrix(aes_air.public_bytes(NONCE, COUNTER0, ct_rows, rows))
    np.testing.assert_array_equal(
        pub, jair.public_matrix(jair.public_bytes(NONCE, COUNTER0, ct_rows, rows)))
    trace1, lk_u, lk_v = got
    rng = np.random.default_rng(key_size)
    z4 = tuple(int(x) for x in rng.integers(0, P31, 4))
    a4 = tuple(int(x) for x in rng.integers(0, P31, 4))
    mine = tp._interaction(lk_u, lk_v, trace1[-1].copy(), z4, a4, rows, "cpu")
    ref = jp._interaction(lk_u, lk_v, trace1[-1].copy(), z4, a4, rows)
    assert mine.dtype == np.uint32
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("m, s", [(8, 1), (64, 1), (2048, 8), (8192, 8)])
def test_sigma_perm_and_cum_column_match_reference(m, s):
    np.testing.assert_array_equal(aes_air.sigma_perm(m, s), jair.sigma_perm(m, s))
    F = np.random.default_rng(m).integers(0, P31, (4, m)).astype(np.uint32)
    np.testing.assert_array_equal(aes_air.cum_column(F, m), jair.cum_column(F, m))


def test_aes_slices_cover_items_in_order():
    """K7d's slices partition its items (the cum sum cut into a cumlk item
    a lookup), none over the gather budget."""
    _, _, groups = aes_air.layout(16)
    idx, off, n, rows = stark_kernels.pack_aes_groups(groups)
    b = stark_kernels.aes_slices(n)
    items = n[0] + n[1] + n[2] + n[3] + 2 * n[4] + 2 + n[5]
    assert b[0] == 0 and b[-1] == items and (np.diff(b) > 0).all()
    counts, gathers = stark_kernels.aes_item_counts(n), stark_kernels.aes_item_gathers()
    costs = np.concatenate([np.full(counts[k], gathers[k])
                            for k in stark_kernels.AES_KINDS])
    per_slice = np.add.reduceat(costs, b[:-1])
    assert per_slice.max() <= stark_kernels.AES_SLICE_GATHERS
    assert stark_kernels.aes_n_constraints(n) == tp.n_constraints(16)
    assert idx.size == off[-1] + 3 * n[-1]
    assert rows[:4] == (int(groups["table"]["M"]), int(groups["table"]["TVAL"]),
                        int(groups["table"]["SVAL"]), int(groups["table"]["TACT"]))


@pytest.mark.parametrize("key_size", [16, 32])
def test_composition_plain_matches_reference(key_size):
    """_composition_plain == the reference's _composition_jit at the 80-byte
    chunk's shape (log_rows 8, M = 2,048) on random values, challenges,
    weights and V_N inverses."""
    n1, n2, groups = aes_air.layout(key_size)
    log_rows = 8
    n, m, _ = tp._domain_params(log_rows)
    rng = np.random.default_rng(100 + key_size)
    R = n1 + n2 + aes_air.N_PUB + 1
    vals = rng.integers(0, P31, (R, m)).astype(np.uint32)
    vals[-1] = 0                                   # the zero row
    weights = rng.integers(0, P31, (tp.n_constraints(key_size), 4)).astype(np.uint32)
    z4 = tuple(int(x) for x in rng.integers(0, P31, 4))
    a4 = tuple(int(x) for x in rng.integers(0, P31, 4))
    vn_inv = tp._vn_evals(log_rows)[1]
    np.testing.assert_array_equal(vn_inv, jp._vn_evals(log_rows)[1])
    perm = aes_air.sigma_perm(m, m // n)
    want = np.asarray(jp._composition_jit(
        jnp.asarray(vals), jnp.asarray(vals[:, perm]),
        jax.tree.map(jnp.asarray, groups), z4, a4, jnp.asarray(weights),
        jnp.asarray(vn_inv)))
    got = tp._composition_plain(torch.from_numpy(vals.astype(np.int32)),
                                torch.from_numpy(perm), groups, z4, a4,
                                torch.from_numpy(weights.astype(np.int32)),
                                torch.from_numpy(vn_inv.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)

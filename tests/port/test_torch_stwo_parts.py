"""Port vs reference: the parts of the "stark-stwo" prover, on the CPU.

Each module that reaches a kernel is held to the JAX package's
``stark/stwo_compat`` on the same inputs (numpy, seeded): the trace made on
tensors equals ``generate_stream_trace`` column for column; the LDE through
CircleFFT (K7b's plain version) and the two row maps equals ``cfft.lde``;
the composition from ``air.layout()``'s K7c groups (K7c's plain version)
equals the reference's ``evaluate_constraints_m31`` accumulated with alpha
powers and divided by V; the trace tree's root and leaves (K7a's plain
version, hashlib) equal ``stwo_compat/merkle.commit``'s. Also: the QM31
power ladder against sequential products, the batched ChaCha20 block
function and keystream word for word against the JAX functions, and the
row maps against the domain points.
"""
import numpy as np
import pytest
import torch

from zksc_tpu.ops import ciphers as jciphers
from zksc_tpu.stark.stwo_compat import air as jair
from zksc_tpu.stark.stwo_compat import cfft as jcfft
from zksc_tpu.stark.stwo_compat import merkle as jmerkle
from zksc_tpu.stark.stwo_compat import prover as jprover
from zksc_tpu.stark.stwo_compat import trace as jtrace
from zksc_tpu.stark.stwo_compat.circle import CanonicCoset
from zksc_tpu_torch.ops import ciphers
from zksc_tpu_torch.stark import merkle as stark_merkle
from zksc_tpu_torch.stark.stwo_compat import air, cfft, field as F
from zksc_tpu_torch.stark.stwo_compat import merkle as tmerkle
from zksc_tpu_torch.stark.stwo_compat import prover as tp
from zksc_tpu_torch.stark.stwo_compat import trace

P = (1 << 31) - 1
KEY_W = [0x03020100 + 0x04040404 * i for i in range(8)]
NONCE_W = [0x0B0A0908, 0x4A000000, 0x00000000]

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def _reference_v(log_size):
    """V = pi^(log_size - 1)(x) at the commitment domain's stored positions,
    as the reference prover builds it (stwo_compat/prover.py:139-143)."""
    cdom = CanonicCoset(log_size + 1).circle_domain()
    return np.array([jprover._pi_k_m31(cdom.at_stored(i)[0], log_size - 1)
                     for i in range(2 << log_size)], dtype=np.int64)


@pytest.fixture(scope="module")
def lde4():
    """Random values at log size 4 over all 33,280 columns, [rows, cols]
    numpy, and the reference's LDE of them."""
    vals = np.random.default_rng(4).integers(0, P, (16, air.N_COLS))
    return vals, jcfft.lde(vals)


def test_trace_matches_reference():
    """3 blocks, counters wrapping past 2^32 - 1: equal column for column,
    and the validity flag as the reference's (also on a bad ciphertext)."""
    rng = np.random.default_rng(3)
    counters = [0xFFFFFFFE, 0xFFFFFFFF, 0]
    pts = rng.integers(0, 1 << 32, (3, 16))
    ks = np.array([jtrace.generate_trace_row(KEY_W, NONCE_W, c)[1]
                   for c in counters])
    cts = pts ^ ks
    want, ok = jtrace.generate_stream_trace(KEY_W, NONCE_W, counters,
                                            pts.tolist(), cts.tolist())
    got, valid = trace.stream_trace(KEY_W, NONCE_W, torch.tensor(counters),
                                    torch.from_numpy(pts), torch.from_numpy(cts))
    assert ok and valid
    assert got.shape == (air.N_COLS, 3)
    assert np.array_equal(got.numpy().T, want)
    cts[1, 5] ^= 1
    _, ok = jtrace.generate_stream_trace(KEY_W, NONCE_W, counters,
                                         pts.tolist(), cts.tolist())
    _, valid = trace.stream_trace(KEY_W, NONCE_W, torch.tensor(counters),
                                  torch.from_numpy(pts), torch.from_numpy(cts))
    assert not ok and not valid
    # the host row oracle copied into the port
    assert trace.generate_trace_row(KEY_W, NONCE_W, 5)[0] == \
        jtrace.generate_trace_row(KEY_W, NONCE_W, 5)[0]


@pytest.mark.parametrize("log_size", [4, 5, 9])
def test_row_maps_pair_the_domain_points(log_size):
    """row_map(log)[j] is the stored position of CircleFFT's point j."""
    dom = CanonicCoset(log_size).circle_domain()
    f = cfft.fft(log_size)
    m = cfft.row_map(log_size)
    assert sorted(m.tolist()) == list(range(1 << log_size))
    for j in (0, 1, 7, (1 << log_size) - 1):
        assert dom.at_stored(int(m[j])) == (int(f.domain_x[j]), int(f.domain_y[j]))


@pytest.mark.parametrize("log_size", [4, 8])
def test_commit_domain_matches_reference(log_size):
    """The commitment domain's points, V and V^-1 built on tensors from the
    row map equal the reference's per-point construction."""
    xs, ys, v, vinv = (t.numpy() for t in tp._commit_domain_on(
        log_size, torch.device("cpu")))
    cdom = CanonicCoset(log_size + 1).circle_domain()
    pts = [cdom.at_stored(i) for i in range(2 << log_size)]
    assert xs.tolist() == [p[0] for p in pts]
    assert ys.tolist() == [p[1] for p in pts]
    assert np.array_equal(v, _reference_v(log_size))
    assert np.array_equal(v * vinv % P, np.ones_like(v))


@pytest.mark.parametrize("log_size", [4, 5, 9])
def test_basis_matches_host_oracle(log_size):
    """The OODS basis built on tensors equals basis_eval_qm31, the port's
    copy and the reference's, at a random QM31 point."""
    rng = np.random.default_rng(log_size)
    point = tuple(tuple(int(v) for v in rng.integers(0, P, 4)) for _ in range(2))
    got = [tuple(r) for r in tp._basis(point, log_size, "cpu").tolist()]
    assert got == trace.basis_eval_qm31(point, log_size)
    assert got == [tuple(int(c) for c in v)
                   for v in jtrace.basis_eval_qm31(point, log_size)]


def test_lde_matches_reference(lde4):
    vals, want = lde4
    coeffs = cfft.interpolate(torch.from_numpy(vals.T.astype(np.int32).copy()))
    assert np.array_equal(coeffs.numpy().T, jcfft.interpolate(vals))
    got = cfft.evaluate(coeffs, 5)
    assert np.array_equal(got.numpy().T, want)
    assert torch.equal(got, cfft.lde(torch.from_numpy(vals.T.astype(np.int32).copy())))


def test_composition_matches_reference(lde4):
    """K7c's plain version over air.layout() at log size 4 (M = 32) equals
    the reference prover's composition: evaluate_constraints_m31, summed
    with alpha^(54,783 - i), divided by V (stwo_compat/prover.py:121-145)."""
    _, lde = lde4                                       # [32, N_COLS]
    alpha = (123456789, 987654321, 55555, 2 ** 30 + 7)
    cons = jair.evaluate_constraints_m31(lde.T)         # [54784, 32]
    apow = [F.ONE] * air.N_CONSTRAINTS
    for i in range(1, air.N_CONSTRAINTS):
        apow[i] = F.mul(apow[i - 1], alpha)
    vinv = np.array([pow(int(v), P - 2, P) for v in _reference_v(4)])
    want = []
    for coord in range(4):
        col = np.array([apow[air.N_CONSTRAINTS - 1 - i][coord]
                        for i in range(air.N_CONSTRAINTS)], dtype=np.int64)
        hi, lo = col >> 16, col & 0xFFFF
        s = ((cons.T @ hi) % P * (1 << 16) + (cons.T @ lo)) % P
        want.append(s * vinv % P)
    vals = torch.zeros((air.N_COLS + 1, 32), dtype=torch.int32)
    vals[:air.N_COLS] = torch.from_numpy(lde.T.astype(np.int32))
    got = tp.composition(vals, alpha, 4)
    assert np.array_equal(got.numpy(), np.stack(want))


def test_layout_counts_and_order():
    groups, order = air.layout()
    assert len(groups["bool"]) == air.N_COLS            # every column is a bit
    assert len(groups["add"]["R"]) == 336 * 32
    assert len(groups["xor"]["R"]) == 320 * 32
    assert len(groups["eq"]["KS"]) == 512
    assert all(len(v) == 0 for v in groups["addx"].values())
    assert sorted(order.tolist()) == list(range(air.N_CONSTRAINTS))
    assert groups["add"]["Cin"].count(air.ZERO_ROW) == 336


def test_trace_tree_matches_reference(lde4):
    """The trace tree (K7a's plain version over the [C, M] LDE) equals
    stwo_compat/merkle.commit leaf for leaf and root for root."""
    _, lde = lde4
    want_root, want_layers = jmerkle.commit([lde[:, c].tolist()
                                             for c in range(air.N_COLS)])
    tree = stark_merkle.commit_columns(torch.from_numpy(lde.T.astype(np.int32).copy()))
    assert tree.root == want_root
    assert [bytes(x) for x in tree.layers[0]] == want_layers[0]
    positions = [3, 17, 30]
    assert jmerkle.decommit(want_layers, positions) == \
        tmerkle.decommit(tree.layers, positions)


def test_qm31_powers_match_sequential_products():
    x = (5, 77, 1 << 29, P - 3)
    got = tp.qm31_powers(x, 1000, torch.device("cpu")).tolist()
    want, cur = [], F.ONE
    for _ in range(1000):
        want.append(list(cur))
        cur = F.mul(cur, x)
    assert got == want


def test_chacha20_block_functions_match_reference():
    """The torch block function and keystream, word for word against the
    JAX package's chacha20_block_words and chacha20_keystream."""
    import jax.numpy as jnp
    rng = np.random.default_rng(20)
    B = 5
    key = rng.integers(0, 256, (B, 32), dtype=np.uint8)
    nonce = rng.integers(0, 256, (B, 12), dtype=np.uint8)
    ctr = np.array([0, 1, 7, 0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint32)
    kw = key.view("<u4").astype(np.uint32)
    nw = nonce.view("<u4").astype(np.uint32)
    want = np.asarray(jciphers.chacha20_block_words(
        jnp.asarray(kw), jnp.asarray(nw), jnp.asarray(ctr)))
    got = ciphers.chacha20_block_words(torch.from_numpy(kw.astype(np.int64)),
                                       torch.from_numpy(nw.astype(np.int64)),
                                       torch.from_numpy(ctr.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    want_ks = np.asarray(jciphers.chacha20_keystream(
        jnp.asarray(key), jnp.asarray(nonce), jnp.asarray(ctr)))
    got_ks = ciphers.chacha20_keystream(torch.from_numpy(key),
                                        torch.from_numpy(nonce),
                                        torch.from_numpy(ctr.astype(np.int64)))
    assert got_ks.dtype == torch.uint8
    assert np.array_equal(got_ks.numpy(), want_ks)

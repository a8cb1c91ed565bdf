"""Port vs reference: the plain versions of the Groth16 H kernels (K0, K4,
K5 in ops/h_kernels.py and ops/ntt.py) and the one-pass quotient
ProverContext._h_pipeline_batch, limb for limb against the JAX package's
compositions (zksc_tpu/groth16/prove.py: _matvec and _h_core;
zksc_tpu/ops/ntt.py's transforms; zksc_tpu/fields/limb.py), at a tiny
domain (n = 8) on random sparse matrices made from a numpy seed: empty
rows, repeated columns, rows past the last constraint. The JAX side shares
one NTTContext, so its transforms compile once for the module (XLA:CPU,
the bulk of the module's seconds). The kernels themselves are held to
these plain versions by test_torch_kernels_emulated.py (CPU) and
chip_smoke.py (the card)."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksc_tpu.fields.limb import Fr as JFr
from zksc_tpu.groth16.prove import ProverContext as JProverContext
from zksc_tpu.ops import ntt as jntt
from zksc_tpu_torch.fields.limb import Fr
from zksc_tpu_torch.groth16.prove import ProverContext
from zksc_tpu_torch.ops import h_kernels
from zksc_tpu_torch.ops import ntt as tntt

N, M_PAD, K = 8, 12, 3


def _rand_fr(rng, count):
    return [int.from_bytes(rng.bytes(32), "little") % Fr.p
            for _ in range(count)]


def _coo(rng, n_rows):
    """One matrix in ProverContext's COO form, rows in order: 0-3 terms a
    row over the first n_rows rows (later rows empty), repeated columns."""
    counts = rng.integers(0, 4, n_rows)
    counts[1] = 0
    counts[2] = 5
    rows = np.repeat(np.arange(n_rows), counts)
    cols = rng.integers(0, M_PAD, rows.size)
    cols[:2] = cols[0]
    return rows, cols, _rand_fr(rng, rows.size)


@pytest.fixture(scope="module")
def case():
    """(JAX stub context and matrices, the port's NTTContext and CSR, z as
    numpy limbs [16, K, M_PAD] in Montgomery form)."""
    rng = np.random.default_rng(1717)
    coo = [_coo(rng, N - 2) for _ in range(3)]
    jstub = types.SimpleNamespace(ntt=jntt.NTTContext(JFr, N))
    jstub._matvec = lambda mat, z: JProverContext._matvec(jstub, mat, z)
    jmats = [(jnp.asarray(r), jnp.asarray(c), jnp.asarray(JFr.to_device(v)))
             for r, c, v in coo]
    csr = h_kernels.CSR.stack(
        [(torch.from_numpy(r), torch.from_numpy(c), Fr.to_device(v))
         for r, c, v in coo], N)
    vals = _rand_fr(rng, K * M_PAD)
    vals[:3] = [0, 1, Fr.p - 1]
    z = Fr.to_device(vals).numpy().reshape(Fr.L, K, M_PAD)
    return jstub, jmats, tntt.NTTContext(Fr, N, device="cpu"), csr, z


def _j(x):
    """Limbs for the JAX package: uint32, as its fields/limb.py keeps them."""
    return jnp.asarray(np.asarray(x).astype(np.uint32))


def _term_coeffs(csr) -> list:
    """Each K5 term's coefficient as the kernel reads it, canonical ints
    mod r: its kind, its value and the wide table decoded on the host."""
    kinds = (csr.terms[:, 0].long() & 0xFFFFFFFF) >> h_kernels.TERM_KIND_SHIFT
    values = csr.terms[:, 1].long() & 0xFFFFFFFF
    wide = [sum(int(limb) << (16 * i) for i, limb in enumerate(w))
            for w in Fr.from_mont(h_kernels.unpack_words(csr.wide)).T.tolist()]
    out = []
    for kd, v in zip(kinds.tolist(), values.tolist()):
        c = wide[v] if kd == h_kernels.TERM_WIDE else v
        neg = kd in (h_kernels.TERM_MINUS_ONE, h_kernels.TERM_MINUS_SMALL)
        out.append((Fr.p - c) % Fr.p if neg else c % Fr.p)
    return out


def _eq(ref, got):
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  got.numpy().astype(np.int64))


def test_csr_row_pointers_match_coo(case):
    """Row r of matrix m holds CSR entries row_ptr[m N + r] ..
    row_ptr[m N + r + 1] - 1: the COO entries of that row, in order; rows
    past the last constraint are empty."""
    _, jmats, _, csr, _ = case
    ptr = csr.row_ptr.long()
    assert ptr.shape == (3 * N + 1,) and int(ptr[0]) == 0
    at = 0
    for m, (rows, cols, _) in enumerate(jmats):
        rows, cols = np.asarray(rows), np.asarray(cols)
        for r in range(N):
            lo, hi = int(ptr[m * N + r]), int(ptr[m * N + r + 1])
            assert hi - lo == int((rows == r).sum())
            np.testing.assert_array_equal(csr.cols[lo:hi].numpy(),
                                          cols[rows == r])
        at += rows.size
        assert int(ptr[(m + 1) * N]) == at
    assert csr.width == int(max(np.asarray(c).max() for _, c, _ in jmats)) + 1
    want = [Fr.from_mont(csr.coeffs[:, t:t + 1]) for t in range(at)]
    want = [sum(int(limb) << (16 * i) for i, limb in enumerate(w[:, 0]))
            for w in want]
    assert _term_coeffs(csr) == want


def test_csr_rejects_unordered_and_out_of_range_rows():
    coeffs = Fr.to_device([1, 2])
    for rows in ([1, 0], [0, N]):
        with pytest.raises(ValueError):
            h_kernels.CSR.stack([(torch.tensor(rows), torch.tensor([0, 1]),
                                  coeffs)], N)


def test_pack_words_round_trip():
    """Two 16-bit limbs a 32-bit word, element after element, the top bit
    kept through int32."""
    vals = [0, 1, Fr.p - 1, 0x8000 << 16, 0xFFFFFFFF << 96]
    words = h_kernels.pack_words(Fr.to_device(vals, mont=False))
    assert words.shape == (len(vals), 8) and words.dtype == torch.int32
    got = [sum((int(w) & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(row))
           for row in words.tolist()]
    assert got == vals


@pytest.mark.parametrize("log_n", [1, 4, 8, 10, 11, 16, 17, 18])
@pytest.mark.parametrize("log_tile", [4, h_kernels.LOG_TILE])
def test_ntt_plan(log_n, log_tile):
    """K4's stage groups cover the log n stages once each, from the largest
    span down; every tile holds 2^log_tile elements (the whole transform
    when it is shorter), its low-index run fits under the group's smallest
    span, and the last group reads contiguous chunks."""
    plan = h_kernels.ntt_plan(log_n, log_tile)
    top = log_n - 1
    for g_top, ns, tl in plan:
        assert g_top == top and 1 <= ns <= log_tile
        assert tl <= g_top - ns + 1
        assert ns + tl == min(log_n, log_tile)
        top -= ns
    assert top == -1 and plan[-1][2] == 0
    assert len(plan) == -(-log_n // log_tile)
    if log_tile == h_kernels.LOG_TILE and log_n >= 16:
        assert len(plan) == 2             # the paths' domains: two launches


def test_sparse_matvec_plain_vs_reference(case):
    """K5's plain version over the stacked CSR equals the reference's
    _matvec of each matrix for each proof."""
    jstub, jmats, _, csr, z = case
    got = h_kernels.sparse_matvec_plain(h_kernels.pack_z(torch.from_numpy(z)),
                                        csr)
    assert got.shape == (Fr.L, 3, K, N) and got.dtype == torch.int32
    for m, mat in enumerate(jmats):
        for j in range(K):
            _eq(JProverContext._matvec(jstub, mat, _j(z[:, j])),
                got[:, m, j])


def test_quotient_plain_vs_reference(case):
    """K0's plain quotient over [16, 3, K, N] equals the reference's
    (a b - c) zinv of each proof; on a CPU tensor the wrapper is it."""
    _, _, ntt, _, _ = case
    rng = np.random.default_rng(18)
    abc = Fr.to_device(_rand_fr(rng, 3 * K * N)).numpy().reshape(
        Fr.L, 3, K, N)
    zinv = pow(ntt.z_coset_int, -1, Fr.p)
    zc = JFr.broadcast_const(zinv, (N,))
    got = h_kernels.quotient_plain(torch.from_numpy(abc), zinv)
    assert got.shape == (Fr.L, K, N)
    for j in range(K):
        a, b, c = (_j(abc[:, i, j]) for i in range(3))
        _eq(JFr.mont_mul(JFr.sub(JFr.mont_mul(a, b), c), zc), got[:, j])
    assert torch.equal(h_kernels.quotient(torch.from_numpy(abc), zinv), got)


@pytest.mark.parametrize("form", ["coset_evals_from_evals",
                                  "coeffs_br_from_coset_evals from_mont"])
def test_folded_transforms_vs_reference(case, form):
    """The transforms with the folded tables over K rows: the coset pass
    (1/n and the shift powers one table between the DIF and the DIT) equals
    the reference's coset_evals_from_coeffs_br(dif_inverse(x)); the way
    back with from_mont folded in equals from_mont of its
    coeffs_br_from_coset_evals."""
    jstub, _, ntt, _, z = case
    x = z[:, :, :N]
    jn = jstub.ntt
    if form == "coset_evals_from_evals":
        got = ntt.coset_evals_from_evals(torch.from_numpy(x))
        ref = lambda r: jn.coset_evals_from_coeffs_br(jn.dif_inverse(r))
    else:
        got = ntt.coeffs_br_from_coset_evals(torch.from_numpy(x),
                                             from_mont=True)
        ref = lambda r: JFr.from_mont(jn.coeffs_br_from_coset_evals(r))
    assert got.shape == (Fr.L, K, N) and got.dtype == torch.int32
    for j in range(K):
        _eq(ref(_j(x[:, j])), got[:, j])


@pytest.mark.parametrize("k", [1, K])
def test_h_pipeline_batch_vs_reference(case, k):
    """ProverContext._h_pipeline_batch over k proofs (the stacked mat-vec,
    one coset pass over 3k rows, the quotient, the way back with from_mont)
    equals the reference's _h_core of each proof, limb for limb."""
    jstub, jmats, ntt, csr, z = case
    stub = types.SimpleNamespace(ntt=ntt, _csr=csr,
                                 _zinv=pow(ntt.z_coset_int, -1, Fr.p))
    got = ProverContext._h_pipeline_batch(stub, torch.from_numpy(z[:, :k]))
    assert got.shape == (Fr.L, k, N)
    for j in range(k):
        _eq(JProverContext._h_core(jstub, _j(z[:, j]), jmats),
            got[:, j])


def test_tile_limit_matches_source():
    """The wrapper's largest K4 tile is the kernel's kNttMaxLogTile, and
    its default tile lies within it."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(h_kernels.__file__), "..", "csrc",
                            "h_kernels.cu")).read()
    m = re.search(r"constexpr int kNttMaxLogTile = (\d+);", src)
    assert m and int(m.group(1)) == h_kernels.MAX_LOG_TILE
    assert 1 <= h_kernels.LOG_TILE <= h_kernels.MAX_LOG_TILE


# coefficients of every K5 class and its edges: +-1, zero, +-c for c < 2^32
# (2^32 - 1 the largest), the smallest wide ones (2^32, r - 2^32), +-2^40
EDGE_COEFFS = [1, Fr.p - 1, 0, 7, Fr.p - 7, (1 << 32) - 1,
               Fr.p - ((1 << 32) - 1), 1 << 32, Fr.p - (1 << 32), 1 << 40,
               Fr.p - (1 << 40)]


def test_csr_bins_and_coefficient_classes():
    """CSR.stack on the host: every stacked row lies in exactly one bin,
    by its length (empty rows and rows of up to SHORT_ROW terms a thread's,
    up to WARP_ROW a warp's, longer ones a block's), each bin in row order;
    every coefficient's kind and value (and the wide table) reproduce it
    mod r, at every class edge and on random values."""
    rng = np.random.default_rng(1818)
    S, W = h_kernels.SHORT_ROW, h_kernels.WARP_ROW
    n = 8
    lengths = [[0, 1, S, S + 1, W, W + 1, 3, 0], [2, 0, 0, S + 1, 1, 0, 0, 5]]
    mats, want = [], []
    for counts in lengths:
        rows = np.repeat(np.arange(n), counts)
        vals = [EDGE_COEFFS[t % len(EDGE_COEFFS)] for t in range(rows.size)]
        vals[::5] = _rand_fr(rng, len(vals[::5]))
        want += vals
        mats.append((torch.from_numpy(rows),
                     torch.from_numpy(rng.integers(0, 40, rows.size)),
                     Fr.to_device(vals)))
    csr = h_kernels.CSR.stack(mats, n)
    counts = np.concatenate(lengths)
    short = np.flatnonzero(counts <= S)
    warp = np.flatnonzero((counts > S) & (counts <= W))
    block = np.flatnonzero(counts > W)
    assert csr.bins == (short.size, warp.size, block.size)
    np.testing.assert_array_equal(csr.bin_rows.numpy(),
                                  np.concatenate([short, warp, block]))
    assert _term_coeffs(csr) == want
    kinds = (csr.terms[:, 0].long() & 0xFFFFFFFF) >> h_kernels.TERM_KIND_SHIFT
    assert sorted(set(kinds.tolist())) == list(range(5))
    np.testing.assert_array_equal(
        (csr.terms[:, 0].long() & ((1 << h_kernels.TERM_KIND_SHIFT) - 1))
        .numpy(), csr.cols.numpy())


@pytest.mark.parametrize("log_n, rows, want", [
    (16, 3, 9), (16, 1, 8), (16, 12, 10), (17, 3, 10), (18, 3, 10),
    (18, 12, 10), (15, 3, 8), (14, 3, 7)])
def test_pick_log_tile(log_n, rows, want):
    """K4's tile from the grid at the paths' shapes (the coset pass over 3k
    rows, the way back over k, a mesh block's three rows of 2^14-2^15): the
    largest tile up to 2^LOG_TILE whose launch has MIN_BLOCKS blocks, and
    never fewer stages a tile than two launches a direction need."""
    t = h_kernels.pick_log_tile(log_n, rows)
    assert t == want
    assert rows << (log_n - t) >= h_kernels.MIN_BLOCKS or \
        t == (log_n + 1) // 2
    plan = h_kernels.ntt_plan(log_n, rows=rows)
    assert len(plan) == 2 and plan == h_kernels.ntt_plan(log_n, t)


def test_pack_z_round_trip(case):
    """pack_z: [16, k, m_pad] limbs -> [k, m_pad, 8] words, element after
    element; unpack_words gives the limbs back."""
    z = torch.from_numpy(case[4])
    words = h_kernels.pack_z(z)
    assert words.shape == (K, M_PAD, 8) and words.dtype == torch.int32
    assert torch.equal(words[1, 2], h_kernels.pack_words(z[:, 1, 2:3])[0])
    assert torch.equal(h_kernels.unpack_words(words), z)


@pytest.mark.parametrize("enum", ["TermKind", "K0Mode"])
def test_kernel_enums_match_source(enum):
    """The wrapper's copies of K5's term kinds (and where they sit in a
    term, kTermKindShift) and of K0's modes are the kernel's own: kTermOne
    is TERM_ONE, kDifHalf is DIF_HALF, ..."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(h_kernels.__file__), "..", "csrc",
                            "h_kernels.cu")).read()
    body = re.search(rf"enum {enum} \{{([^}}]*)\}}", src).group(1)
    pairs = re.findall(r"k(\w+) = (\d+)", body)
    assert len(pairs) == 5
    for name, value in pairs:
        py = re.sub(r"(?<!^)(?=[A-Z])", "_", name).upper()
        assert getattr(h_kernels, py) == int(value), py
    m = re.search(r"constexpr int kTermKindShift = (\d+);", src)
    assert m and int(m.group(1)) == h_kernels.TERM_KIND_SHIFT

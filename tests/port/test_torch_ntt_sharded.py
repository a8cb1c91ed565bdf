"""Port vs reference: the mesh-sharded NTT (ops/ntt_sharded.py).

At (n, D) = (64, 8) and (128, 4), each of the four transforms of
ShardedNTT over make_mesh(D) (D shards on the CPU) equals, limb for limb,
the JAX package's NTTContext and the port's NTTContext on the same inputs
(numpy, seeded), and the round trip comes back; the two forms the sharded
H pass runs (the coset pass with each block's local DIF, scale and DIT in
one step, and the way back with from_mont) over blocks of three rows equal
the JAX package's compositions, at D = 2 too. At (64, 4) the C-point local
stages and the exchanged stages equal the JAX package's own ShardedNTT on
its CPU mesh. Exact: tolerance 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksc_tpu.fields.limb import Fr as JFr
from zksc_tpu.ops import ntt as jntt
from zksc_tpu_torch.fields.limb import Fr
from zksc_tpu_torch.ops.ntt import NTTContext
from zksc_tpu_torch.ops.ntt_sharded import ShardedNTT
from zksc_tpu_torch.parallel.mesh import make_mesh

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

TRANSFORMS = ("dif_inverse", "dit_forward", "coset_evals_from_coeffs_br",
              "coeffs_br_from_coset_evals")


@pytest.fixture(scope="module", params=[(64, 8), (128, 4)],
                ids=["n64-D8", "n128-D4"])
def ctx(request):
    n, D = request.param
    rng = np.random.RandomState(n + D)
    vals = [int(v) for v in rng.randint(1, 2**31, size=n)]
    vals[0], vals[1] = 0, JFr.p - 1
    x = np.asarray(JFr.to_device(vals)).astype(np.int32)
    ntt = NTTContext(Fr, n, device="cpu")
    return jntt.NTTContext(JFr, n), ntt, ShardedNTT(ntt, make_mesh(D, ["cpu"])), x


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_matches_jax_and_one_device(ctx, name):
    jc, tc, sh, x = ctx
    xt = torch.from_numpy(x)
    blocks = sh.sharding.shard(xt)
    assert len(blocks) == sh.D and all(b.shape == (Fr.L, sh.C) for b in blocks)
    got = sh.sharding.gather(getattr(sh, name)(blocks))
    want = getattr(tc, name)(xt)
    ref = np.asarray(getattr(jc, name)(jnp.asarray(x.astype(np.uint32))))
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  ref.astype(np.int64))


def test_roundtrips(ctx):
    _, _, sh, x = ctx
    blocks = sh.sharding.shard(torch.from_numpy(x))
    back = sh.dit_forward(sh.dif_inverse(blocks))
    assert torch.equal(sh.sharding.gather(back), torch.from_numpy(x))
    coset = sh.coset_evals_from_coeffs_br(blocks)
    back = sh.coeffs_br_from_coset_evals(coset)
    assert torch.equal(sh.sharding.gather(back), torch.from_numpy(x))


def test_mesh_must_tile_the_domain():
    ntt = NTTContext(Fr, 16, device="cpu")
    with pytest.raises(ValueError, match="tile"):
        ShardedNTT(ntt, make_mesh(3, ["cpu"]))
    with pytest.raises(ValueError, match="tile"):
        ShardedNTT(ntt, make_mesh(32, ["cpu"]))
    sh = ShardedNTT(ntt, make_mesh(4, ["cpu"]))
    with pytest.raises(ValueError, match="blocks"):
        sh.dif_inverse([torch.zeros((Fr.L, 4), dtype=torch.int32)] * 2)


def _rows3(x, n, seed):
    """x [16, n] and two more seeded rows -> [16, 3, n]."""
    rng = np.random.RandomState(seed)
    more = [np.asarray(JFr.to_device([int(v) for v in
                                      rng.randint(0, 2**31, size=n)]))
            for _ in range(2)]
    return np.stack([x] + [m.astype(np.int32) for m in more], axis=1)


def _jax_form(jc, form, row):
    r = jnp.asarray(row.astype(np.uint32))
    if form == "coset_evals_from_evals":
        return jc.coset_evals_from_coeffs_br(jc.dif_inverse(r))
    return JFr.from_mont(jc.coeffs_br_from_coset_evals(r))


@pytest.mark.parametrize("D", [None, 2])
@pytest.mark.parametrize("form", ["coset_evals_from_evals",
                                  "coeffs_br_from_coset_evals from_mont"])
def test_h_pass_forms_match_jax(ctx, form, D):
    """The sharded H's two transforms over [16, 3, C] blocks (D: the
    fixture's mesh, or 2 shards) equal the JAX package's compositions row
    by row and the port's one-device forms."""
    jc, tc, sh, x = ctx
    if D is not None:
        sh = ShardedNTT(tc, make_mesh(D, ["cpu"]))
    x3 = _rows3(x, tc.n, tc.n + 3)
    xt = torch.from_numpy(x3)
    blocks = sh.sharding.shard(xt)
    assert blocks[0].shape == (Fr.L, 3, sh.C)
    if form == "coset_evals_from_evals":
        got = sh.coset_evals_from_evals(blocks)
        want = tc.coset_evals_from_evals(xt)
    else:
        got = sh.coeffs_br_from_coset_evals(blocks, from_mont=True)
        want = tc.coeffs_br_from_coset_evals(xt, from_mont=True)
    got = sh.sharding.gather(got)
    assert torch.equal(got, want)
    for j in range(3):
        np.testing.assert_array_equal(
            got[:, j].numpy().astype(np.int64),
            np.asarray(_jax_form(jc, form, x3[:, j])).astype(np.int64))


def test_local_and_exchanged_stages_match_jax_sharded():
    """The port's ShardedNTT at n = 64 on 4 shards (the C-point local
    stages over every 4th twiddle, the exchanged stages through the
    cross-stage halves) equals the JAX package's ShardedNTT on its CPU
    mesh of 4, for the two transforms the coset pipeline composes."""
    from zksc_tpu.ops.ntt_sharded import ShardedNTT as JShardedNTT
    from zksc_tpu.parallel.mesh import make_mesh as j_make_mesh
    import jax
    n, D = 64, 4
    rng = np.random.RandomState(n * D)
    x = np.asarray(JFr.to_device([int(v) for v in
                                  rng.randint(0, 2**31, size=n)]))
    jsh = JShardedNTT(jntt.NTTContext(JFr, n), j_make_mesh(D))
    sh = ShardedNTT(NTTContext(Fr, n, device="cpu"), make_mesh(D, ["cpu"]))
    xj = jax.device_put(jnp.asarray(x.astype(np.uint32)), jsh.sharding)
    xt = sh.sharding.shard(torch.from_numpy(x.astype(np.int32)))
    for name in ("dif_inverse", "dit_forward"):
        got = sh.sharding.gather(getattr(sh, name)(xt))
        ref = np.asarray(getattr(jsh, name)(xj))
        np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                      ref.astype(np.int64))

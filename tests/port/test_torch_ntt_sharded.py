"""Port vs reference: the mesh-sharded NTT (ops/ntt_sharded.py).

At (n, D) = (64, 8) and (128, 4), each of the four transforms of
ShardedNTT over make_mesh(D) (D shards on the CPU) equals, limb for limb,
the JAX package's NTTContext and the port's NTTContext on the same inputs
(numpy, seeded), and the round trip comes back. Exact: tolerance 0."""
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

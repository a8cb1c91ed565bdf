"""The port's mesh (parallel/mesh.py) and how Groth16Operator picks one.

make_mesh over explicit devices (repeated: the CPU stands in for several
cards), the lane placement helpers (G2's folded coordinates split by
points), and Groth16Operator's mesh= / ZKSC_MESH: a mesh only when it has
more than one shard, passed on to the ProverContext."""
import pytest
import torch

from zksc_tpu_torch import operators
from zksc_tpu_torch.fields.limb import Fp
from zksc_tpu_torch.ops import ec
from zksc_tpu_torch.parallel import mesh as pm


def test_make_mesh_repeats_devices():
    m = pm.make_mesh(4, ["cpu"])
    assert m.size == 4 and m.all_local and m.local_shards == [0, 1, 2, 3]
    assert all(d == torch.device("cpu") for d in m.devices)
    assert pm.make_mesh(devices=["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError):
        pm.make_mesh(0, ["cpu"])
    with pytest.raises(ValueError):
        pm.make_mesh(2, [])
    assert pm.SHARD_AXIS == "shard"


def test_lane_placement_roundtrips():
    m = pm.make_mesh(4, ["cpu"])
    x = torch.arange(3 * 16, dtype=torch.int32).reshape(3, 16)
    blocks = pm.lane_sharding(m).shard(x)
    assert [b.tolist() for b in blocks] == [x[:, 4 * d:4 * d + 4].tolist()
                                            for d in range(4)]
    assert torch.equal(pm.lane_sharding(m).gather(blocks), x)
    assert all(b.is_contiguous() for b in blocks)      # as K1-K3 take them
    bits = torch.arange(2 * 3 * 8).reshape(2, 3, 8)
    bb = pm.shard_bits(bits, m)
    assert [b.shape for b in bb] == [(2, 3, 2)] * 4
    assert torch.equal(pm.bits_sharding(m).gather(bb), bits)
    assert [r.data_ptr() for r in pm.replicate(x, m)] == [x.data_ptr()] * 4
    with pytest.raises(ValueError, match="tile"):
        pm.lane_sharding(m).shard(torch.zeros((1, 6)))


def test_shard_jac_splits_g2_points_not_halves():
    pts = [(i + 1, i + 2) for i in range(8)]
    P = ec.g1_points_to_device(Fp, pts, device="cpu")
    g2 = ec.JacPoint(*(torch.cat([a, a + 7], dim=1) for a in P))  # [L, 2*8]
    m = pm.make_mesh(2, ["cpu"])
    shards = pm.shard_jac(g2, m, g2=True)
    for d, s in enumerate(shards):
        c0, c1 = s.x[:, :4], s.x[:, 4:]
        assert torch.equal(c0, P.x[:, 4 * d:4 * d + 4])
        assert torch.equal(c1, P.x[:, 4 * d:4 * d + 4] + 7)
    g1 = pm.shard_jac(P, m)
    assert torch.equal(g1[1].y, P.y[:, 4:])


def test_operator_picks_a_mesh_only_above_one_shard(monkeypatch):
    monkeypatch.delenv("ZKSC_MESH", raising=False)
    G = operators.Groth16Operator
    assert G("chacha20", device="cpu").mesh is None
    assert G("chacha20", device="cpu", mesh=pm.make_mesh(1, ["cpu"])).mesh \
        is None
    m2 = pm.make_mesh(2, ["cpu"])
    assert G("chacha20", device="cpu", mesh=m2).mesh is m2
    for env, size in (("all", None), ("1", None), ("4", 4)):
        monkeypatch.setenv("ZKSC_MESH", env)
        op = G("chacha20", device="cpu")
        assert (None if op.mesh is None else op.mesh.size) == size, env
    assert op.mesh.devices == (torch.device("cpu"),) * 4
    # the operator's prover gets the mesh
    seen = {}

    class Ctx:
        def __init__(self, cs, pk, device=None, mesh=None):
            seen.update(device=device, mesh=mesh)

    import zksc_tpu_torch.groth16 as g16
    from zksc_tpu_torch.groth16 import artifacts
    monkeypatch.setattr(g16, "ProverContext", Ctx)
    monkeypatch.setattr(artifacts, "load_keys",
                        lambda d, expected_digest, device: (None, None))
    op._ensure_keys()
    assert seen == {"device": torch.device("cpu"), "mesh": op.mesh}

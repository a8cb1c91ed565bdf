"""Port vs reference: the multi-device prover (a mesh of shards on the CPU).

The toy circuit of test_torch_prove.py (out == x^13 + x + 41, plus an
8-bit decomposition; m_pad 32, domain 32). Its keys come from the port's
setup under the fixed random.Random(23), which equals the JAX package's
setup point for point (test_torch_setup.py), and are read by the JAX
package from the port's files.

- the sharded window sums (ops/msm.py:_window_sums_sharded, D = 4) over
  G1 and G2 equal the host oracle's MSM (curve/bn254_host.py);
- the sharded H limbs (D = 2, 4, 8: each shard's row slice of the
  mat-vec, the C-point local stages) equal the port's one-device
  compute_h_batch and the JAX package's one-device quotient (its _h_core, which
  compute_h_batch vmaps, run eagerly: ~60 s of XLA:CPU against ~95 s for
  the vmapped program);
- a force_pippenger proof on a D = 8 mesh and a ladder-branch proof on a
  D = 4 mesh equal the JAX package's one-device proof under the same rng,
  as test_torch_prove.py computes it (its five MSMs and the quotient by
  the package's host arithmetic: zksc_tpu's own prove costs ~150 s of
  XLA:CPU for this circuit); both verify under both packages' verifiers,
  which reject a tampered public input.

All exact: tolerance 0."""
import random

import numpy as np
import pytest
import torch

from test_torch_prove import OUT, PRIV, PUB, X, _blinding, _expected_proof, define
from zksc_tpu.curve import bn254_host as host
from zksc_tpu.groth16 import ProverContext as JProverContext
from zksc_tpu.groth16 import artifacts as jart
from zksc_tpu.groth16 import verify as jverify
from zksc_tpu.groth16.prove import Proof as JProof
from zksc_tpu.r1cs import compile_circuit as j_compile
from zksc_tpu_torch.fields.limb import Fp, Fr
from zksc_tpu_torch.groth16 import ProverContext, setup, verify as tverify
from zksc_tpu_torch.groth16 import artifacts as tart
from zksc_tpu_torch.ops import ec, msm
from zksc_tpu_torch.parallel.mesh import Mesh, make_mesh
from zksc_tpu_torch.r1cs import compile_circuit as t_compile
from zksc_tpu_torch.r1cs import generate_witness as t_witness

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    cs = t_compile(define, PUB, PRIV)
    srng = random.Random(23)
    pk, vk = setup(cs, rng=lambda: srng.randrange(2, host.R), device="cpu")
    d = str(tmp_path_factory.mktemp("toy_keys"))
    tart.save_keys(d, pk, vk)
    jcs = j_compile(define, PUB, PRIV)
    jpk, jvk = jart.load_keys(d, expected_digest=jcs.digest())
    wit = t_witness(define, PUB, PRIV, {"out": [[OUT]]}, {"x": [[X]]},
                    batch=1)[:, 0]
    return cs, pk, jcs, jpk, jvk, wit


def _host_msm(pts, scalars, g2):
    add, mul = (host.g2_add, host.g2_mul) if g2 else (host.g1_add, host.g1_mul)
    acc = None
    for p, s in zip(pts, scalars):
        if p is not None and s:
            acc = add(acc, mul(p, s))
    return acc


@pytest.mark.parametrize("g2", [False, True], ids=["G1", "G2"])
def test_window_sums_sharded_match_host(g2):
    rng = random.Random(41 + g2)
    n, n_bits = 32, 20
    gen, mul = (host.G2_GEN, host.g2_mul) if g2 else (host.G1_GEN, host.g1_mul)
    pts = [mul(gen, rng.randrange(1, host.R)) for _ in range(n - 2)]
    pts += [None, pts[0]]                  # the identity, a repeated point
    to_dev = ec.g2_points_to_device if g2 else ec.g1_points_to_device
    P = to_dev(Fp, pts, device="cpu")
    sets = [[rng.randrange(1 << n_bits) for _ in range(n)] for _ in range(2)]
    sets[1][:4] = [0, 1, (1 << n_bits) - 1, 0]
    limbs = torch.stack([Fr.to_device(s, mont=False, device="cpu")
                         for s in sets], dim=1)                # [L, 2, n]
    fops = ec.G2_OPS if g2 else ec.G1_OPS
    mesh = make_mesh(4, ["cpu"])
    pending = msm.msm_pippenger_device(fops, P, limbs, n_bits, mesh=mesh)
    assert pending.D == 4 and len(pending.sums) == 4
    got = msm.msm_to_host_affine(fops, pending, 2)
    assert got == [_host_msm(pts, s, g2) for s in sets]
    assert got == msm.msm_pippenger(fops, P, limbs, n_bits)   # one device


@pytest.fixture(scope="module")
def jax_h(toy):
    """(z_mont of the toy witness, the JAX package's one-device quotient of
    it, the port's one-device H): the reference every sharded H is held
    to."""
    cs, pk, jcs, jpk, _, wit = toy
    one = ProverContext(cs, pk, device="cpu")
    z_mont, _, _ = one._witnesses_to_device([wit])
    jctx = JProverContext(jcs, jpk)
    jz, _, _ = jctx._witnesses_to_device([wit])
    np.testing.assert_array_equal(np.asarray(jz).astype(np.int64),
                                  z_mont.numpy().astype(np.int64))
    jh = np.asarray(jctx._h_core(jz[:, 0], jctx._mats))
    return z_mont, jh, one.compute_h_batch(z_mont)


def test_sharded_h_equals_jax_and_one_device(toy, jax_h):
    cs, pk = toy[0], toy[1]
    z_mont, jh, h1 = jax_h
    sharded = ProverContext(cs, pk, mesh=make_mesh(8, ["cpu"]))
    assert sharded._h_sharded is not None and sharded.device.type == "cpu"
    h8 = sharded.compute_h_batch(z_mont)
    assert torch.equal(h8, h1)
    np.testing.assert_array_equal(jh.astype(np.int64),
                                  h8[:, 0].numpy().astype(np.int64))
    # a domain that does not tile the mesh: no sharded quotient
    assert ProverContext(cs, pk, mesh=make_mesh(64, ["cpu"]))._h_sharded \
        is None


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_h_row_slices_match_jax(toy, jax_h, D):
    """At D = 2 and 4 each shard's mat-vec takes the CSR slice of its own
    rows of A, B and C (no partial sums, no reduce-scatter) and the local
    stages run the C-point transform: the H limbs still equal the JAX
    package's one-device quotient and the port's one-device H."""
    cs, pk = toy[0], toy[1]
    z_mont, jh, h1 = jax_h
    ctx = ProverContext(cs, pk, mesh=make_mesh(D, ["cpu"]))
    h = ctx.compute_h_batch(z_mont)
    assert torch.equal(h, h1)
    np.testing.assert_array_equal(jh.astype(np.int64),
                                  h[:, 0].numpy().astype(np.int64))


@pytest.mark.parametrize("D,force", [(8, True), (4, False)],
                         ids=["pippenger-D8", "ladder-D4"])
def test_mesh_proof_equals_reference(toy, D, force):
    cs, pk, jcs, jpk, jvk, wit = toy
    ctx = ProverContext(cs, pk, mesh=make_mesh(D, ["cpu"]),
                        force_pippenger=force)
    assert (ctx.m_pad >= 256 or ctx.force_pippenger) == force
    proof = ctx.prove(wit, rng=_blinding())
    A, B, C = _expected_proof(jpk, jcs, wit, _blinding())
    assert (proof.a, proof.b, proof.c) == (A, B, C)
    jp = JProof(proof.a, proof.b, proof.c)
    assert jverify(jvk, jp, [OUT]) and tverify(jvk, proof, [OUT])
    assert not jverify(jvk, jp, [OUT + 1])
    assert not tverify(jvk, proof, [OUT + 1])


def test_prover_mesh_must_be_local(toy):
    cs, pk = toy[0], toy[1]
    remote = Mesh(["cpu", None], ranks=[0, 1], rank=0)
    with pytest.raises(ValueError, match="every shard"):
        ProverContext(cs, pk, mesh=remote)
    with pytest.raises(ValueError, match="device exactly"):
        Mesh(["cpu", "cpu"], ranks=[0, 1], rank=0)

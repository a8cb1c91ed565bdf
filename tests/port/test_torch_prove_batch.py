"""Port: the batched Groth16 path, k proofs in one pass, as the JAX package
runs it (groth16/prove.py: _h_pipeline_batch vmaps one proof's quotient
over the proof axis; operators.py builds the k witnesses on min(4, k)
threads).

Toy circuit of test_torch_prove.py (out == x^13 + x + 41, plus an 8-bit
decomposition), keys from the port's setup on the CPU (equal to the JAX
package's, test_torch_setup.py) and read by the JAX package from the
port's files, as test_torch_prove_mesh.py does; three witnesses from
distinct x. The oracle is the JAX prover's algorithm in host arithmetic
that test_torch_prove.py holds the one-proof path to (_quotient,
_expected_proof): the reference's vmapped H program costs ~95 s of
XLA:CPU (tools/time_jax_oracles.py prove). Every comparison is exact.

The operator's threaded witnesses equal the serial ones, in order (three
chacha20 chunks on the native tape), and threads that race to build an
unrecorded witness tape record it once."""
import collections
import random
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_prove import PRIV, PUB, _blinding, _expected_proof, \
    _quotient, define
from zksc_tpu.curve import bn254_host as host
from zksc_tpu.groth16 import artifacts as jart
from zksc_tpu.groth16 import verify as jverify
from zksc_tpu.groth16.prove import Proof as JProof
from zksc_tpu_torch import api as tapi
from zksc_tpu_torch import operators as tops
from zksc_tpu_torch.fields.limb import Fr
from zksc_tpu_torch.groth16 import ProverContext, setup, verify as tverify
from zksc_tpu_torch.groth16 import artifacts as tart
from zksc_tpu_torch.ops.ntt import NTTContext, bit_reverse_perm
from zksc_tpu_torch.r1cs import compile_circuit, generate_witness
from zksc_tpu_torch.r1cs.tape import build_tape

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

XS = (7, 11, 19)


def _out(x):
    return (pow(x, 13, host.R) + x + 41) % host.R


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    cs = compile_circuit(define, PUB, PRIV)
    srng = random.Random(23)
    pk, vk = setup(cs, rng=lambda: srng.randrange(2, host.R), device="cpu")
    d = str(tmp_path_factory.mktemp("toy_keys"))
    tart.save_keys(d, pk, vk)
    jpk, jvk = jart.load_keys(d, expected_digest=cs.digest())
    wits = [generate_witness(define, PUB, PRIV, {"out": [[_out(x)]]},
                             {"x": [[x]]}, batch=1)[:, 0] for x in XS]
    return cs, pk, jpk, jvk, wits


class _OpCount(TorchDispatchMode):
    """Counts, by name, the aten ops dispatched under it that compute: a
    view (an expand that broadcasts a table over k > 1 rows, a reshape, a
    slice) launches no kernel and is not counted."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_compute_h_batch_equals_quotient(toy):
    cs, pk, _, _, wits = toy
    ctx = ProverContext(cs, pk, device="cpu")
    z_mont, _, _ = ctx._witnesses_to_device(wits)
    h = ctx.compute_h_batch(z_mont)
    n = pk.domain_n
    assert tuple(h.shape) == (Fr.L, len(XS), n)
    br = bit_reverse_perm(n)
    for j, wit in enumerate(wits):
        q = _quotient(cs, [int(v) % host.R for v in wit], n)
        assert Fr.from_device(h[:, j], mont=False) == \
            [q[int(br[i])] for i in range(n)]
        assert torch.equal(ctx._h_core(z_mont[:, j]), h[:, j])


@pytest.mark.parametrize("force_pippenger", [False, True],
                         ids=["ladder", "pippenger"])
def test_prove_batch_equals_reference(toy, force_pippenger):
    cs, pk, jpk, jvk, wits = toy
    ctx = ProverContext(cs, pk, device="cpu", force_pippenger=force_pippenger)
    assert ctx.m_pad == 32
    proofs = ctx.prove_batch(wits, rng=_blinding())
    want_rng = _blinding()           # one blinding sequence for the batch
    for x, wit, proof in zip(XS, wits, proofs):
        assert (proof.a, proof.b, proof.c) == \
            _expected_proof(jpk, cs, wit, want_rng)
        assert jverify(jvk, JProof(proof.a, proof.b, proof.c), [_out(x)])
        assert tverify(jvk, proof, [_out(x)])
        assert not tverify(jvk, proof, [_out(x) + 1])


def test_h_pipeline_op_count_independent_of_k(toy):
    cs, pk, _, _, wits = toy
    ctx = ProverContext(cs, pk, device="cpu")
    z_mont, _, _ = ctx._witnesses_to_device(wits)
    counts = []
    for k in (1, len(XS)):
        z = z_mont[:, :k].contiguous()
        with _OpCount() as c:
            ctx.compute_h_batch(z)
        counts.append(c.ops)
    assert counts[0] == counts[1]
    assert counts[0]["aten.index_add_.default"] == 1   # A, B, C stacked


@pytest.mark.parametrize("k", [2, Fr.L])
@pytest.mark.parametrize("name", ["dif_inverse", "dit_forward",
                                  "coset_evals_from_coeffs_br",
                                  "coeffs_br_from_coset_evals"])
def test_ntt_batch_rows_equal_one_row_transforms(k, name):
    n = 32
    ntt = NTTContext(Fr, n, device="cpu")
    rng = random.Random(1000 + k)
    vals = [rng.randrange(Fr.p) for _ in range(k * n)]
    x = Fr.to_device(vals, device="cpu").reshape(Fr.L, k, n)
    fn = getattr(ntt, name)
    got = fn(x)
    assert tuple(got.shape) == (Fr.L, k, n)
    assert torch.equal(got, torch.stack([fn(x[:, j]) for j in range(k)],
                                        dim=1))


class _RecordingPool(tops.ThreadPoolExecutor):
    workers = []

    def __init__(self, max_workers=None, **kw):
        _RecordingPool.workers.append(max_workers)
        super().__init__(max_workers=max_workers, **kw)


class _FakeContext:
    """Stands in for the prover: keeps the witnesses it is given."""
    timings: dict = {}

    def __init__(self):
        self.witnesses = None

    def prove_batch(self, witnesses, rng=None):
        self.witnesses = witnesses
        return []


def test_operator_builds_witnesses_on_threads_in_order(monkeypatch):
    key, iv = bytes(range(32)), bytes(range(100, 112))
    wis = [tapi.generate_zk_witness(
        "chacha20", key, bytes((7 * i + 3 * c + c * c) & 0xFF
                               for i in range(128)), iv) for c in range(3)]
    op = tops.Groth16Operator("chacha20", device="cpu")
    serial = [op.spec.build_witness(wi) for wi in wis]
    assert all(w.dtype.name == "uint64" for w in serial)  # the native tape
    monkeypatch.setattr(tops, "ThreadPoolExecutor", _RecordingPool)
    _RecordingPool.workers = []
    op._ctx = _FakeContext()
    op.prove_batch(wis)
    assert _RecordingPool.workers == [3]
    got = op._ctx.witnesses
    assert len(got) == len(serial)
    for a, b in zip(got, serial):
        assert (a == b).all()
    assert any((serial[0] != w).any() for w in serial[1:])
    assert op.timings["witness_s"] > 0


def test_tape_recorded_once_under_racing_threads():
    recorded = []

    def fresh(api, v):          # a new function object: a key not yet cached
        recorded.append(1)
        time.sleep(0.01)        # hand the other threads the interpreter
        define(api, v)

    with ThreadPoolExecutor(max_workers=16) as ex:
        tapes = list(ex.map(lambda _: build_tape(fresh, PUB, PRIV),
                            range(16), timeout=60))
    assert len(recorded) == 1
    assert tapes[0] is not None and all(t is tapes[0] for t in tapes)

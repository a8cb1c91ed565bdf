"""One of two cooperating processes of test_torch_multihost.py.

Joins a two-process gloo group through zksc_tpu_torch.parallel.multihost,
builds the global mesh of 4 shards (2 CPU shards per process) and runs the
four sharded NTT transforms, whose hypercube exchanges at span 16 cross the
process boundary; each of this process's shards must equal the one-device
transform limb for limb. Prints MULTIHOST-NTT-OK proc=<pid> on success.

    python torch_multihost_worker.py <pid> <port> <repo_root>
"""
import sys

pid, port, repo = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, repo)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from zksc_tpu_torch.fields.limb import Fr  # noqa: E402
from zksc_tpu_torch.ops.ntt import NTTContext  # noqa: E402
from zksc_tpu_torch.ops.ntt_sharded import ShardedNTT  # noqa: E402
from zksc_tpu_torch.parallel import multihost  # noqa: E402

torch.set_num_threads(1)
assert multihost.initialize(f"127.0.0.1:{port}", 2, pid, backend="gloo"), \
    "distributed init must report active"
assert multihost.initialize() is True, "a second call must be idempotent"
assert multihost.process_count() == 2 and multihost.process_index() == pid

mesh = multihost.global_mesh(devices=["cpu", "cpu"])
assert mesh.size == 4 and mesh.local_shards == [2 * pid, 2 * pid + 1], mesh
assert multihost.local_mesh(devices=["cpu", "cpu"]).size == 2

# host_slice covers [0, 10) disjointly across the two processes
s = multihost.host_slice(10)
assert s == (slice(0, 5) if pid == 0 else slice(5, 10)), s

n = 32
ntt = NTTContext(Fr, n, device="cpu")
sntt = ShardedNTT(ntt, mesh)
rng = np.random.RandomState(0)
full = Fr.to_device([int(v) for v in rng.randint(1, 2**31, size=n)],
                    device="cpu")
blocks = sntt.sharding.shard(full)
assert blocks[2 - 2 * pid] is None and blocks[2 * pid] is not None
for name in ("dif_inverse", "dit_forward", "coset_evals_from_coeffs_br",
             "coeffs_br_from_coset_evals"):
    want = getattr(ntt, name)(full)
    got = getattr(sntt, name)(blocks)
    for d in mesh.local_shards:
        assert torch.equal(got[d], want[:, d * sntt.C:(d + 1) * sntt.C]), \
            f"proc {pid} shard {d} {name} mismatch"
    assert all(got[d] is None for d in range(4) if not mesh.is_local(d))

print(f"MULTIHOST-NTT-OK proc={pid}", flush=True)

"""Kernel launch calls, host synchronisations and time of the bucket-MSM
stage of one warm chacha20 Groth16 proof of the PyTorch port, on one GPU.

Usage: python3 tools/msm_stage_torch.py [--sync-error]

Proves a 128-byte chacha20 chunk twice with the committed key
(artifacts/chacha20), records the arguments of the five
msm_pippenger_device calls of the second proof (A, B1, B2, C and H), and
replays those five calls:

  - once under torch.profiler (CUDA activity): the host's kernel launch
    calls (cudaLaunchKernel / cuLaunchKernel events) and the card's
    kernel time;
  - once under torch.cuda.set_sync_debug_mode: "warn" counts the calls
    that synchronise with the host; with --sync-error, "error" makes the
    first one raise;
  - three times more on the host clock, each ending in
    torch.cuda.synchronize(): the stage's seconds (msm_device_s's span).

Prints one JSON line. The script works on any checkout of the port that
has ops/msm.py:msm_pippenger_device: copy it into an older checkout's
tools/ to measure that one on the same card.
"""
import json
import os
import random
import sys
import time
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def capture_msm_calls(prove) -> list:
    """The (args, kwargs) of every msm_pippenger_device call that
    prove() makes, in order."""
    from zksc_tpu_torch.ops import msm
    calls = []
    orig = msm.msm_pippenger_device

    def rec(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)
    msm.msm_pippenger_device = rec
    try:
        prove()
    finally:
        msm.msm_pippenger_device = orig
    return calls


def replay(calls):
    from zksc_tpu_torch.ops import msm
    return [msm.msm_pippenger_device(*a, **kw) for a, kw in calls]


def launch_calls(calls) -> tuple:
    """(host launch calls, card ms) of one replay under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        replay(calls)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    n = sum(1 for e in events
            if e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    dev_ms = sum(e.duration_ns() for e in events
                 if e.device_type() == DeviceType.CUDA) / 1e6
    return n, dev_ms


SYNC_WARNING = "called a synchronizing CUDA operation"


def sync_calls(calls, error: bool) -> tuple:
    """(synchronising calls, the other warnings' texts) of one replay under
    set_sync_debug_mode; with error=True the first synchronising call
    raises."""
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("error" if error else "warn")
        try:
            replay(calls)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    texts = [str(w.message) for w in seen]
    return (sum(1 for t in texts if SYNC_WARNING in t),
            sorted({t[:160] for t in texts if SYNC_WARNING not in t}))


def stage_seconds(calls, reps: int = 3) -> float:
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        replay(calls)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t)
    return min(out)


def measure(api, error: bool = False) -> dict:
    """Two chacha20 proofs (the first loads the key), the second's five
    MSM calls recorded, then replayed as the module docstring says."""
    import torch
    rnd = random.Random(2024)
    key = bytes(rnd.randrange(256) for _ in range(32))
    iv = bytes(rnd.randrange(256) for _ in range(12))
    ct = bytes(rnd.randrange(256) for _ in range(128))
    blind = random.Random(7)
    rng = lambda: blind.randrange(1, 1 << 250)
    prove = lambda: api.generate_proof("chacha20", key, ct, iv, device="cuda",
                                       rng=rng)
    prove()
    calls = capture_msm_calls(prove)
    if len(calls) != 5:
        raise AssertionError(f"expected 5 MSM calls a proof, saw {len(calls)}")
    replay(calls)                                   # warm-up
    torch.cuda.synchronize()
    n, dev_ms = launch_calls(calls)
    syncs, other = sync_calls(calls, error)
    return {"msm_calls": len(calls), "launch_calls": n, "syncs": syncs,
            "other_warnings": other,
            "card_ms_profiled": dev_ms,
            "stage_s": stage_seconds(calls),
            "shapes": [[tuple(a[2].shape), a[3]] for a, _ in calls]}


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("msm_stage_torch: CUDA is not available", file=sys.stderr)
        return 2
    from zksc_tpu_torch import api
    res = measure(api, error="--sync-error" in argv)
    res["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

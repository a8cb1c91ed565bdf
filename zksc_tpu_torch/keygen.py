"""Keygen CLI: compile a circuit, run the trusted setup on the GPU, write
digest-pinned keys (pk.npz, pk_meta.json, vk.json) and manifest.json.

    python -m zksc_tpu_torch.keygen [--algorithm ALG] [--out DIR] [--seed N]

ALG is one of chacha20, aes-128-ctr, aes-256-ctr, chacha20-toprf,
aes-128-ctr-toprf, aes-256-ctr-toprf (default: all six in turn).

The default --out is the port's key store, zksc_tpu_torch/build/artifacts/
(ignored by git), never the committed artifacts/ tree. --seed makes the
toxic waste deterministic (random.Random(seed)); it is for tests and smoke
runs only, a key made so is not secret. Without it the toxic waste comes
from the secrets module.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import time

from .api import PORTED_ALGORITHMS

KEY_STORE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "artifacts")


def seeded_rng(seed: int):
    """() -> int in [1, r): deterministic toxic waste for tests."""
    from .curve import bn254_host as host
    r = random.Random(seed)
    return lambda: r.randrange(1, host.R)


def run(algorithm: str, out_root: str = KEY_STORE, seed: int | None = None,
        log=print) -> dict:
    """Setup + save for one algorithm. Returns the seconds of each stage."""
    from .groth16 import artifacts as art
    from .groth16.setup import setup
    from .operators import CircuitSpec

    times = {}
    t0 = time.perf_counter()
    cs = CircuitSpec(algorithm).cs
    times["compile_s"] = time.perf_counter() - t0
    log(f"[{algorithm}] compiled: {cs.n_constraints} constraints, "
        f"{cs.n_wires} wires, {cs.n_public} public "
        f"({times['compile_s']:.1f} s)")
    t0 = time.perf_counter()
    pk, vk = setup(cs, rng=None if seed is None else seeded_rng(seed),
                   timings=times)
    times["setup_s"] = time.perf_counter() - t0
    log(f"[{algorithm}] setup done ({times['setup_s']:.1f} s), "
        f"domain 2^{pk.domain_n.bit_length() - 1}")
    out_dir = os.path.join(out_root, algorithm)
    t0 = time.perf_counter()
    art.save_keys(out_dir, pk, vk)
    manifest = {
        "algorithm": algorithm,
        "digest": cs.digest(),
        "n_constraints": cs.n_constraints,
        "n_wires": cs.n_wires,
        "n_public": cs.n_public,
        "domain_n": pk.domain_n,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    times["save_s"] = time.perf_counter() - t0
    log(f"[{algorithm}] keys -> {out_dir} ({times['save_s']:.1f} s)")
    return times


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algorithm", choices=PORTED_ALGORITHMS, default=None,
                    help="default: all")
    ap.add_argument("--out", default=KEY_STORE)
    ap.add_argument("--seed", type=int, default=None,
                    help="deterministic toxic waste (tests only)")
    args = ap.parse_args(argv)
    for alg in [args.algorithm] if args.algorithm else PORTED_ALGORITHMS:
        run(alg, args.out, args.seed)


if __name__ == "__main__":
    main()

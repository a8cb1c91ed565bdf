"""Generate the 1-block ChaCha20 Groth16 keys with the PyTorch port
(zksc_tpu_torch), on one device, by default the GPU.

The trusted setup of `python -m zksc_tpu_torch.keygen`, for the compact
cipher circuit (one 64-byte block: 22,432 constraints, domain 2^15). The
keys go into the port's key store, zksc_tpu_torch/build/artifacts/
chacha20-1block (gitignored), never under artifacts/.

Usage: python tools/gen_oneblock_artifacts_torch.py [--device cuda|cpu]
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT_DIR = os.path.join(ROOT, "zksc_tpu_torch", "build", "artifacts",
                       "chacha20-1block")


def compile_one_block():
    from zksc_tpu_torch.r1cs import compile_circuit
    from zksc_tpu_torch.r1cs.circuits import chacha20 as cc
    return compile_circuit(cc.make_define(1), cc.public_layout(1),
                           cc.private_layout(1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    from zksc_tpu_torch.device import resolve_device
    from zksc_tpu_torch.groth16 import artifacts as art
    from zksc_tpu_torch.groth16.setup import setup
    dev = resolve_device(args.device)
    cs = compile_one_block()
    t0 = time.perf_counter()
    pk, vk = setup(cs, device=dev)
    t1 = time.perf_counter()
    art.save_keys(OUT_DIR, pk, vk)
    print(f"saved {OUT_DIR} constraints {cs.n_constraints} digest "
          f"{cs.digest()} setup {t1 - t0:.2f} s save "
          f"{time.perf_counter() - t1:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

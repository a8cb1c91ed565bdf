"""STARK engine benchmark of the PyTorch port (zksc_tpu_torch) on one
device, by default the GPU: blocks per second of the chacha20 stream
prover at a range of log sizes, plus an AES-128-CTR row.

    python tools/bench_stark_torch.py [--chacha-logs 10,14,17]
        [--aes-blocks 1024] [--repeat 2] [--device cuda|cpu]

Prints one JSON object per benchmark line, with the keys of the JAX
package's tools/bench_stark.py.

Which sizes one H100 (80 GB) holds: the chacha20 prover's peak device
memory grows about linearly with its evaluation domain M = 8 * 2^log
(log >= 8). chip_smoke.py measured 0.787 GiB at M = 2,048 (log 8, a
16 KiB record), which by that linear estimate puts log 10 near 3 GiB,
log 14 near 50 GiB and log 17 near 400 GiB: the default's log 17 does not
fit on one card (14 and 17 have not been run). The AES prover takes at
most 4,096 blocks (aes_prover.MAX_LOG_ROWS).
"""
import argparse
import json
import os
import secrets
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_chacha(log_rows: int, dev) -> dict:
    from zksc_tpu_torch.ops.ciphers import chacha20_encrypt
    from zksc_tpu_torch.stark import prover as sp
    n_blocks = 1 << log_rows
    key, nonce = secrets.token_bytes(32), secrets.token_bytes(12)
    pt = secrets.token_bytes(64 * n_blocks)
    ct = chacha20_encrypt(key, nonce, 1, pt)
    t0 = time.time()
    proof = sp.prove_stream(key, nonce, 1, pt, ct, device=dev)
    prove_s = time.time() - t0
    t0 = time.time()
    ok = sp.verify_stream(proof, nonce, 1, pt, ct, device=dev)
    verify_s = time.time() - t0
    return {"bench": "stark_chacha_stream", "log_rows": log_rows,
            "blocks": n_blocks, "prove_s": round(prove_s, 2),
            "blocks_per_s": round(n_blocks / prove_s, 1),
            "verify_s": round(verify_s, 2), "valid": ok,
            "proof_bytes": proof.to_envelope()["proof_size_bytes"]}


def bench_aes(n_blocks: int, dev) -> dict:
    from zksc_tpu_torch.ops.ciphers import aes_ctr_encrypt
    from zksc_tpu_torch.stark import aes_prover as ap
    key, nonce = secrets.token_bytes(16), secrets.token_bytes(12)
    pt = secrets.token_bytes(16 * n_blocks)
    ct = aes_ctr_encrypt(key, nonce, 2, pt)
    t0 = time.time()
    proof = ap.prove_aes_ctr(key, nonce, 2, pt, ct, device=dev)
    prove_s = time.time() - t0
    t0 = time.time()
    ok = ap.verify_aes_ctr(proof, nonce, 2, pt, ct, 16, device=dev)
    verify_s = time.time() - t0
    return {"bench": "stark_aes128_ctr", "blocks": n_blocks,
            "prove_s": round(prove_s, 2),
            "blocks_per_s": round(n_blocks / prove_s, 1),
            "verify_s": round(verify_s, 2), "valid": ok,
            "proof_bytes": proof.to_envelope()["proof_size_bytes"]}


def main(argv=None):
    ap_ = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap_.add_argument("--chacha-logs", default="10,14,17")
    ap_.add_argument("--aes-blocks", type=int, default=1024)
    ap_.add_argument("--repeat", type=int, default=2,
                     help="runs per size (the first builds the kernels)")
    ap_.add_argument("--device", default=None,
                     help="torch device (default cuda)")
    args = ap_.parse_args(argv)
    from zksc_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    for log_rows in [int(x) for x in args.chacha_logs.split(",") if x]:
        for r in range(args.repeat):
            rep = bench_chacha(log_rows, dev)
            rep["run"] = r
            print(json.dumps(rep), flush=True)
    if args.aes_blocks:
        for r in range(args.repeat):
            rep = bench_aes(args.aes_blocks, dev)
            rep["run"] = r
            print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

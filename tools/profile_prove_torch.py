"""Per-stage timing of the chacha20 Groth16 prove path of the PyTorch port
(zksc_tpu_torch) on one device, by default the GPU.

Usage: python tools/profile_prove_torch.py [batch] [--device cuda|cpu]

Prints one line per stage: the mean wall seconds of 3 runs after a warm-up
run, each ending in torch.cuda.synchronize() on the GPU, over the
committed chacha20 key (artifacts/chacha20). The MSM lines include their
host window combine (msm_pippenger).
"""
import argparse
import os
import secrets
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench(label, fn, dev, iters=3):
    fn()                                    # warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    print(f"{label:36s} {dt * 1e3:9.1f} ms", flush=True)
    return dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=1,
                    help="proofs per prove_batch (default 1)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions, slowly)")
    args = ap.parse_args(argv)

    import torch

    from zksc_tpu_torch import api
    from zksc_tpu_torch.device import resolve_device
    from zksc_tpu_torch.ops import ec, msm

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device {name}, batch {args.batch}", flush=True)
    key, iv = secrets.token_bytes(32), secrets.token_bytes(12)
    data = secrets.token_bytes(128)
    op = api.get_operator("chacha20", "groth16", dev)
    wi = api.generate_zk_witness("chacha20", key=key, ciphertext=data, iv=iv)

    t0 = time.perf_counter()
    wit = op.spec.build_witness(wi)
    print(f"{'witness build (host)':36s} "
          f"{(time.perf_counter() - t0) * 1e3:9.1f} ms", flush=True)

    t0 = time.perf_counter()
    op._ensure_keys()
    print(f"{'keys load + context':36s} "
          f"{(time.perf_counter() - t0) * 1e3:9.1f} ms", flush=True)
    ctx = op._ctx
    pk = ctx.pk
    wits = [wit] * args.batch

    t0 = time.perf_counter()
    z_mont, z_plain, nb = ctx._witnesses_to_device(wits)
    _sync(dev)
    print(f"{'witness->device':36s} {(time.perf_counter() - t0) * 1e3:9.1f} "
          f"ms  n_bits={nb}", flush=True)

    bench("H pipeline (matvec+NTT)", lambda: ctx.compute_h_batch(z_mont), dev)
    h_plain = ctx.compute_h_batch(z_mont)
    ell = pk.n_public + 1
    priv_plain = z_plain[:, :, ell:ell + ctx.c_pad]
    if priv_plain.shape[2] < ctx.c_pad:
        priv_plain = torch.nn.functional.pad(
            priv_plain, (0, ctx.c_pad - priv_plain.shape[2]))

    for label, fops, pts, sc, bits in [
        ("MSM A (G1, wires)", ec.G1_OPS, pk.a_query, z_plain, nb),
        ("MSM B1 (G1, wires)", ec.G1_OPS, pk.b_g1_query, z_plain, nb),
        ("MSM B2 (G2, wires)", ec.G2_OPS, pk.b_g2_query, z_plain, nb),
        ("MSM C (G1, priv)", ec.G1_OPS, pk.c_query, priv_plain, nb),
        ("MSM H (G1, 254-bit)", ec.G1_OPS, pk.h_query, h_plain, 254),
    ]:
        bench(label, lambda f=fops, p=pts, s=sc, b=bits:
              msm.msm_pippenger(f, p, s, b), dev)

    t0 = time.perf_counter()
    ctx.prove_batch(wits)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"{'full prove_batch':36s} {dt * 1e3:9.1f} ms  ({args.batch} "
          f"proofs, {args.batch / dt:.3f} proofs/s)", flush=True)
    print("stages " + " ".join(f"{k}={v:.4f}" for k, v in ctx.timings.items()),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

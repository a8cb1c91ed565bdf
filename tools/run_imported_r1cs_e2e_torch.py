"""One run of the imported gnark R1CS Groth16 end to end on the PyTorch
port (zksc_tpu_torch), on one device, by default the GPU, with timings
printed as JSON.

The reference checkout's compiled chacha20 circuit
(<resources>/gnark/r1cs.chacha20, gnark v0.14; <resources> is
$ZKSC_REFERENCE_RESOURCES, else ~/reference/resources) is parsed, a
ChaCha20 witness is solved through it in the reference prover's bit
orders, the keys are set up (cached in the port's key store,
zksc_tpu_torch/build/artifacts/imported-gnark-chacha20) and a proof is
made and verified; a tampered public input must be rejected. Without the
file the tool exits with status 2 and names the missing path.

Usage: python tools/run_imported_r1cs_e2e_torch.py [--device cuda|cpu]
"""
import argparse
import json
import os
import secrets
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CACHE = os.path.join(ROOT, "zksc_tpu_torch", "build", "artifacts",
                     "imported-gnark-chacha20")


def r1cs_path() -> str:
    from zksc_tpu_torch.interop.circom_wasm import reference_resources
    return os.path.join(reference_resources(), "gnark", "r1cs.chacha20")


def _chacha_assignment(cs, key: bytes, nonce: bytes, counter: int,
                       ciphertext: bytes):
    """name -> bit assignments in the reference prover's bit orders
    (gnark/libraries/prover/impl/provers.go:152-174: key / nonce LE u32
    words, counter raw u32, in / out BE u32 words; all bits LSB first)."""
    from zksc_tpu_torch.ops.ciphers import chacha20_encrypt
    blocks = 2
    plaintext = b"".join(
        chacha20_encrypt(key, nonce, counter + b,
                         ciphertext[64 * b:64 * (b + 1)])
        for b in range(blocks))

    def le_words(data):
        return [int.from_bytes(data[4 * i:4 * i + 4], "little")
                for i in range(len(data) // 4)]

    def be_words(data):
        return [int.from_bytes(data[4 * i:4 * i + 4], "big")
                for i in range(len(data) // 4)]

    key_w, nonce_w = le_words(key), le_words(nonce)
    in_w, out_w = be_words(ciphertext), be_words(plaintext)
    public, secret = {}, {}
    for name in cs.public_names[1:]:
        parts = name.split("_")
        kind, idx = parts[0], [int(x) for x in parts[1:]]
        if kind == "Counter":
            b, k = idx
            public[name] = ((counter + b) >> k) & 1
        elif kind == "Nonce":
            b, w, k = idx
            public[name] = (nonce_w[w] >> k) & 1
        elif kind in ("In", "Out"):
            w, k = idx[-2], idx[-1]
            if len(idx) == 3:
                w = idx[0] * 16 + idx[1]
            words = in_w if kind == "In" else out_w
            public[name] = (words[w] >> k) & 1
        else:
            raise ValueError(f"unexpected public wire {name}")
    for name in cs.secret_names:
        parts = name.split("_")
        if parts[0] != "Key":
            raise ValueError(f"unexpected secret wire {name}")
        w, k = int(parts[1]), int(parts[2])
        secret[name] = (key_w[w] >> k) & 1
    return public, secret, plaintext


def _setup_cached(cs_native, device):
    from zksc_tpu_torch.groth16 import artifacts as art
    from zksc_tpu_torch.groth16.setup import setup
    if os.path.exists(os.path.join(CACHE, "pk.npz")):
        return art.load_keys(CACHE, expected_digest=cs_native.digest(),
                             device=device)
    pk, vk = setup(cs_native, device=device)
    art.save_keys(CACHE, pk, vk)
    return pk, vk


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    path = r1cs_path()
    if not os.path.exists(path):
        print(f"run_imported_r1cs_e2e_torch: the reference's R1CS file is "
              f"missing: {path} (set ZKSC_REFERENCE_RESOURCES)",
              file=sys.stderr)
        return 2

    import numpy as np

    from zksc_tpu_torch.device import resolve_device
    from zksc_tpu_torch.groth16 import ProverContext, verify
    from zksc_tpu_torch.interop.gnark_r1cs import parse_r1cs

    dev = resolve_device(args.device)
    rep = {}
    t0 = time.time()
    cs = parse_r1cs(path)
    rep["parse_s"] = round(time.time() - t0, 2)
    rep["n_constraints"] = cs.nb_constraints
    key, nonce = secrets.token_bytes(32), secrets.token_bytes(12)
    ciphertext = secrets.token_bytes(128)
    public, secret, _ = _chacha_assignment(cs, key, nonce, 5, ciphertext)
    t0 = time.time()
    w = cs.solve_witness(public, secret)
    if not cs.check_witness(w):
        raise RuntimeError("the solved witness does not satisfy the R1CS")
    rep["witness_s"] = round(time.time() - t0, 2)
    cs_native = cs.to_constraint_system()
    t0 = time.time()
    pk, vk = _setup_cached(cs_native, dev)
    rep["setup_s"] = round(time.time() - t0, 2)
    ctx = ProverContext(cs_native, pk, device=dev)
    t0 = time.time()
    proof = ctx.prove(np.array(w, dtype=object))
    rep["prove_s"] = round(time.time() - t0, 2)
    pub_vals = [int(x) for x in w[1:cs.nb_public]]
    t0 = time.time()
    rep["valid"] = verify(vk, proof, pub_vals)
    rep["verify_s"] = round(time.time() - t0, 2)
    bad = list(pub_vals)
    bad[0] ^= 1
    rep["tamper_rejected"] = not verify(vk, proof, bad)
    print(json.dumps(rep), flush=True)
    return 0 if rep["valid"] and rep["tamper_rejected"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""Behavioural cross-check: the PyTorch port's stark engine against the
reference's stwo backend, on one device, by default the GPU.

Both provers run on identical random inputs and their acceptance is
compared: the reference runs natively through the port's WASM VM
(zksc_tpu_torch.interop.stwo_wasm, the reference checkout's
<resources>/stwo/s2circuits_bg.wasm; <resources> is
$ZKSC_REFERENCE_RESOURCES, else ~/reference/resources), the port's
engine through zksc_tpu_torch.stark. Each verifier must accept its own
honest proof and reject a tampered ciphertext. Prints a JSON report;
exits 0 when they agree. Without the WASM file the tool exits with
status 2 and names the missing path.

Usage:
  python tools/stwo_crosscheck_torch.py [--algorithm chacha20] [--blocks 2]
      [--device cuda|cpu]
"""
import argparse
import json
import os
import secrets
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def wasm_path() -> str:
    from zksc_tpu_torch.interop.circom_wasm import reference_resources
    return os.path.join(reference_resources(), "stwo", "s2circuits_bg.wasm")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--algorithm", default="chacha20",
                    choices=["chacha20", "aes-128-ctr", "aes-256-ctr"])
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    path = wasm_path()
    if not os.path.exists(path):
        print(f"stwo_crosscheck_torch: the reference's stwo WASM is "
              f"missing: {path} (set ZKSC_REFERENCE_RESOURCES)",
              file=sys.stderr)
        return 2

    from zksc_tpu_torch.device import resolve_device
    from zksc_tpu_torch.interop.stwo_wasm import load_reference_stwo
    from zksc_tpu_torch.ops.ciphers import aes_ctr_encrypt, chacha20_encrypt
    from zksc_tpu_torch.stark import aes_prover
    from zksc_tpu_torch.stark import prover as sp

    dev = resolve_device(args.device)
    alg = args.algorithm
    if alg == "chacha20":
        key = secrets.token_bytes(32)
        bs, counter0, enc = 64, 1, chacha20_encrypt
    else:
        key = secrets.token_bytes(16 if alg == "aes-128-ctr" else 32)
        bs, counter0, enc = 16, 2, aes_ctr_encrypt
    nonce = secrets.token_bytes(12)
    pt = secrets.token_bytes(bs * args.blocks)
    ct = enc(key, nonce, counter0, pt)
    report = {"algorithm": alg, "blocks": args.blocks}

    # ---- the reference's prover and verifier (native WASM)
    sw = load_reference_stwo()

    def ref_verify(proof, ct_):
        if alg == "chacha20":
            return sw.verify_chacha20_proof(proof, nonce, counter0, pt, ct_)
        return sw.verify_aes_ctr_proof(proof, nonce, counter0, pt, ct_)

    t0 = time.time()
    if alg == "chacha20":
        ref = sw.generate_chacha20_proof(key, nonce, counter0, pt, ct)
    else:
        ref = sw.generate_aes_ctr_proof(len(key), key, nonce, counter0,
                                        pt, ct)
    report["ref_prove_s"] = round(time.time() - t0, 2)
    report["ref_success"] = bool(ref.get("success"))
    if ref.get("success"):
        t0 = time.time()
        report["ref_valid"] = ref_verify(ref["proof"], ct).get("valid")
        report["ref_verify_s"] = round(time.time() - t0, 2)
        report["ref_proof_bytes"] = ref.get("proof_size_bytes")

    # ---- the port's stark engine on the same inputs
    def our_verify(proof, ct_):
        if alg == "chacha20":
            return sp.verify_stream(proof, nonce, counter0, pt, ct_,
                                    device=dev)
        return aes_prover.verify_aes_ctr(proof, nonce, counter0, pt, ct_,
                                         len(key), device=dev)

    t0 = time.time()
    if alg == "chacha20":
        ours = sp.prove_stream(key, nonce, counter0, pt, ct, device=dev)
    else:
        ours = aes_prover.prove_aes_ctr(key, nonce, counter0, pt, ct,
                                        device=dev)
    report["our_prove_s"] = round(time.time() - t0, 2)
    t0 = time.time()
    report["our_valid"] = our_verify(ours, ct)
    report["our_verify_s"] = round(time.time() - t0, 2)
    report["our_proof_bytes"] = ours.to_envelope()["proof_size_bytes"]

    # both must reject a tampered ciphertext
    bad = bytearray(ct)
    bad[0] ^= 1
    rv = ref_verify(ref["proof"], bytes(bad)) if ref.get("success") else {}
    report["ref_rejects_tamper"] = rv.get("valid") is not True
    report["our_rejects_tamper"] = our_verify(ours, bytes(bad)) is not True
    report["agree"] = (report.get("ref_valid") is True
                       and report.get("our_valid") is True
                       and report["ref_rejects_tamper"]
                       and report["our_rejects_tamper"])
    print(json.dumps(report, indent=2), flush=True)
    return 0 if report["agree"] else 1


if __name__ == "__main__":
    sys.exit(main())

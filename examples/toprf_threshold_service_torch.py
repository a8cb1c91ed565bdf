"""Threshold-OPRF over the wire: one HTTP service per key share, over the
PyTorch port's OPRF operator (zksc_tpu_torch.oprf.operator).

The reference simulates all n share servers in-process (js/src/tests/
oprf.test.ts:52-64 loops over shares calling evaluateOPRF directly; the
real deployment puts each share behind an attestor endpoint). This example
wires the same protocol over an actual transport: each share server is a
stdlib HTTP service exposing POST /evaluate with the gnark-parity JSON wire
format (base64 compressed BabyJubJub points, DLEQ c/r scalars — the shapes
of gnark/libraries/verifier/oprf/library.go's OPRFEvaluate), and the client
drives blind -> fan-out evaluate -> threshold finalize against `threshold`
of the `total` servers.

Run:  python examples/toprf_threshold_service_torch.py [--servers 5 --threshold 3]

The flow (and the wire shapes) are exactly what `OPRFOperator` produces, so
anything that speaks this protocol can replace the in-process servers —
including non-Python implementations.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zksc_tpu_torch.oprf.operator import make_oprf_operator  # noqa: E402


class ShareServer(ThreadingHTTPServer):
    """One threshold-share holder: knows ONLY its own share's private key."""

    def __init__(self, share: dict, address=("127.0.0.1", 0)):
        super().__init__(address, _Handler)
        self.share = share
        self.operator = make_oprf_operator()

    @property
    def url(self) -> str:
        return f"http://{self.server_address[0]}:{self.server_address[1]}"

    def start(self) -> "ShareServer":
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return self


class _Handler(BaseHTTPRequestHandler):
    def do_POST(self):
        if self.path != "/evaluate":
            self.send_error(404)
            return
        try:
            body = json.loads(
                self.rfile.read(int(self.headers["Content-Length"])))
            # the server evaluates with ITS share secret; the response carries
            # the share index + public key so the client can Lagrange-combine
            out = self.server.operator.evaluate_oprf(
                self.server.share["privateKey"], body["maskedData"])
            out["index"] = self.server.share["index"]
            out["publicKeyShare"] = self.server.share["publicKey"]
            payload = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        except Exception as e:  # malformed request -> JSON error, not a 500
            payload = json.dumps({"error": str(e)}).encode()
            self.send_response(400)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    def log_message(self, *a):                       # quiet
        pass


def _post(url: str, obj: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def run_flow(data: bytes, domain_separator: str, total: int, threshold: int,
             verbose: bool = True) -> dict:
    """Full remote threshold flow; returns {"output": b64} nullifier."""
    op = make_oprf_operator()

    keys = op.generate_threshold_keys(total, threshold)
    servers = [ShareServer(s).start() for s in keys["shares"]]
    try:
        request = op.generate_oprf_request_data(data, domain_separator)
        if verbose:
            print(f"blinded {data!r} -> maskedData "
                  f"{request['maskedData'][:16]}…")
        # fan out to any `threshold` of the servers over HTTP
        responses = [_post(srv.url + "/evaluate",
                           {"maskedData": request["maskedData"]})
                     for srv in servers[:threshold]]
        if verbose:
            for r in responses:
                print(f"  share {r['index']} @ evaluated "
                      f"{r['evaluated'][:16]}… (DLEQ attached)")
        # finalize checks every share's DLEQ proof + share-pubkey
        # reconstruction against the master public key, then unmasks
        out = op.finalise_oprf(keys["publicKey"], request, responses)
        if verbose:
            print(f"nullifier: {out['output']}")
        return out
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--servers", type=int, default=5)
    ap.add_argument("--threshold", type=int, default=3)
    ap.add_argument("--data", default="user@example.com")
    ap.add_argument("--domain", default="reclaim")
    args = ap.parse_args()
    run_flow(args.data.encode(), args.domain, args.servers, args.threshold)


if __name__ == "__main__":
    main()

"""Port vs reference: the artifact fetch layer (zksc_tpu_torch.file_fetch),
the artifacts CLI over it (tools/artifacts_cli_torch.py), structured logging
and trace spans (zksc_tpu_torch.utils.logging: torch.profiler in place of
the JAX profiler), and the HTTP threshold-OPRF share service over the port's
OPRF operator (examples/toprf_threshold_service_torch.py). The counterparts
of tests/test_file_fetch.py and tests/test_toprf_service.py; nothing is
fetched from the network (the remote fetcher gets a stubbed urlopen), the
share servers listen on 127.0.0.1.

Tolerance: none (exact).
"""
import hashlib
import io
import json
import os
import random
import sys
import urllib.error
import urllib.request
import zipfile

import pytest

from zksc_tpu import file_fetch as jff
from zksc_tpu.oprf.operator import make_oprf_operator as j_make_operator
from zksc_tpu_torch import file_fetch as ff
from zksc_tpu_torch.oprf.operator import make_oprf_operator
from zksc_tpu_torch.utils.logging import Logger, default_logger, trace_span

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "examples"))

import artifacts_cli_torch  # noqa: E402
from toprf_threshold_service_torch import ShareServer, _post, run_flow  # noqa: E402


class FakeResponse(io.BytesIO):
    status = 200

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_local_fetch(tmp_path):
    d = tmp_path / "store" / "groth16"
    d.mkdir(parents=True)
    (d / "pk.bin").write_bytes(b"hello")
    fetch = ff.make_local_file_fetch(str(tmp_path / "store"))
    assert fetch("groth16", "pk.bin") == b"hello" == \
        jff.make_local_file_fetch(str(tmp_path / "store"))("groth16", "pk.bin")
    with pytest.raises(ff.FetchError, match="local artifact missing"):
        fetch("groth16", "missing.bin")


@pytest.mark.parametrize("mod", [jff, ff], ids=["jax", "port"])
def test_remote_fetch_retries_then_succeeds(mod):
    calls = []

    def fake_urlopen(url, timeout=None):
        calls.append((url, timeout))
        if len(calls) < 3:
            raise OSError("connection reset")
        return FakeResponse(b"artifact-bytes")

    fetch = mod.make_remote_file_fetch("https://pin.example/v1", backoff_s=0.0,
                                       timeout_s=7.0, _urlopen=fake_urlopen)
    assert fetch("gnark", "pk.chacha20") == b"artifact-bytes"
    assert calls == [("https://pin.example/v1/gnark/pk.chacha20", 7.0)] * 3


def test_remote_fetch_exhausts_retries_and_rejects_status():
    def down(url, timeout=None):
        raise urllib.error.URLError("no route")

    fetch = ff.make_remote_file_fetch("https://pin.example/v1/", backoff_s=0.0,
                                      _urlopen=down)
    with pytest.raises(ff.FetchError, match="after 3 attempts"):
        fetch("gnark", "pk.chacha20")

    class NotFound(FakeResponse):
        status = 404

    seen = []
    fetch = ff.make_remote_file_fetch(
        "https://pin.example/v1", retries=2, backoff_s=0.0,
        _urlopen=lambda url, timeout=None: seen.append(url) or NotFound(b""))
    with pytest.raises(ff.FetchError, match="HTTP 404"):
        fetch("stark", "params.bin")
    assert len(seen) == 2


def test_pinned_fetch_checks_sha256(tmp_path):
    d = tmp_path / "snarkjs"
    d.mkdir()
    (d / "a.zkey").write_bytes(b"zkey-data")
    fetch = ff.make_local_file_fetch(str(tmp_path))
    pin = hashlib.sha256(b"zkey-data").hexdigest()
    assert ff.fetch_pinned(fetch, "snarkjs", "a.zkey", pin.upper()) == b"zkey-data"
    for mod in (jff, ff):
        with pytest.raises(mod.FetchError, match="integrity pin mismatch"):
            mod.fetch_pinned(fetch, "snarkjs", "a.zkey", "00" * 32)


def test_mirror_artifacts(tmp_path):
    src = tmp_path / "src" / "gnark"
    src.mkdir(parents=True)
    (src / "vk.bin").write_bytes(b"vk")
    (src / "pk.bin").write_bytes(b"pk")
    fetch = ff.make_local_file_fetch(str(tmp_path / "src"))
    manifest = {"gnark": {"vk.bin": hashlib.sha256(b"vk").hexdigest(),
                          "pk.bin": hashlib.sha256(b"pk").hexdigest()}}
    dest = tmp_path / "dst"
    written = ff.mirror_artifacts(fetch, manifest, str(dest))
    assert written == jff.mirror_artifacts(fetch, manifest, str(dest)) == [
        str(dest / "gnark" / "vk.bin"), str(dest / "gnark" / "pk.bin")]
    assert (dest / "gnark" / "vk.bin").read_bytes() == b"vk"


def test_logger_levels_and_records(capsys, monkeypatch):
    log = Logger(min_level="info", stream=sys.stderr)
    log.debug("hidden")
    log.info("shown", n=3)
    log.error("bad", path=os.path)              # non-JSON values via str()
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 2 and "hidden" not in err[0]
    rec = json.loads(err[0])
    assert (rec["level"], rec["msg"], rec["n"]) == ("info", "shown", 3)
    monkeypatch.setenv("ZKSC_LOG", "warn")
    assert default_logger()._min == Logger.LEVELS.index("warn")
    monkeypatch.setenv("ZKSC_LOG", "")
    default_logger().error("silent")
    assert capsys.readouterr().err == ""


def test_trace_span_logs_and_writes_trace(capsys, monkeypatch, tmp_path):
    import torch
    monkeypatch.delenv("ZKSC_TRACE_DIR", raising=False)
    monkeypatch.setenv("ZKSC_LOG", "debug")
    with trace_span("unit-span", x=1):
        pass
    rec = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert rec["span"] == "unit-span" and rec["x"] == 1 and "seconds" in rec

    trace_dir = tmp_path / "traces"
    monkeypatch.setenv("ZKSC_TRACE_DIR", str(trace_dir))
    with trace_span("prove-span"):
        torch.arange(64).reshape(8, 8).sum()
    trace = json.loads((trace_dir / "prove-span.json").read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    assert "prove-span" in names                # the record_function range
    assert any(n and n.startswith("aten::") for n in names)
    with pytest.raises(KeyError):               # the body's exception escapes
        with trace_span("failing-span"):
            raise KeyError("x")
    assert not (trace_dir / "failing-span.json").exists()


def test_artifacts_cli_publish_roundtrip(tmp_path):
    root = tmp_path / "artifacts"
    (root / "groth16").mkdir(parents=True)
    (root / "groth16" / "vk.json").write_bytes(b'{"vk": 1}')
    (root / "stark").mkdir()
    (root / "stark" / "params.bin").write_bytes(b"\x00\x01\x02")

    out = tmp_path / "release.zip"
    manifest = artifacts_cli_torch.publish(str(root), str(out))
    assert set(manifest) == {"groth16", "stark"}
    unpacked = tmp_path / "unpacked"
    with zipfile.ZipFile(out) as z:
        z.extractall(unpacked)
    assert json.loads((unpacked / "manifest.json").read_text()) == manifest
    assert artifacts_cli_torch.main(["manifest", str(root), "-o",
                                     str(tmp_path / "m.json")]) == 0
    assert json.loads((tmp_path / "m.json").read_text()) == manifest
    rc = artifacts_cli_torch.main([
        "download", "--manifest", str(unpacked / "manifest.json"),
        "--dest", str(tmp_path / "mirror"), "--from-dir", str(unpacked)])
    assert rc == 0
    for engine, files in manifest.items():
        for name in files:
            assert (tmp_path / "mirror" / engine / name).read_bytes() == \
                (root / engine / name).read_bytes()


def _seeded(seed: int):
    rnd = random.Random(seed)
    return lambda: rnd.randrange(2, 2**250)


def test_remote_flow_matches_local_and_reference():
    op = make_oprf_operator(rng=_seeded(7))
    keys = op.generate_threshold_keys(5, 3)
    request = op.generate_oprf_request_data(b"user@example.com", "reclaim")
    # the JAX operator, drawing the same seeded values, agrees on the wire
    jop = j_make_operator(rng=_seeded(7))
    assert jop.generate_threshold_keys(5, 3) == keys
    assert jop.generate_oprf_request_data(b"user@example.com",
                                          "reclaim") == request

    local = []
    for s in keys["shares"][:3]:
        r = op.evaluate_oprf(s["privateKey"], request["maskedData"])
        r.update(index=s["index"], publicKeyShare=s["publicKey"])
        local.append(r)
    local_out = op.finalise_oprf(keys["publicKey"], request, local)
    servers = [ShareServer(s).start() for s in keys["shares"][:3]]
    try:
        remote = [_post(srv.url + "/evaluate",
                        {"maskedData": request["maskedData"]})
                  for srv in servers]
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    remote_out = op.finalise_oprf(keys["publicKey"], request, remote)
    assert remote_out["output"] == local_out["output"]
    assert jop.finalise_oprf(keys["publicKey"], request,
                             remote)["output"] == remote_out["output"]


def test_full_flow_smoke():
    out = run_flow(b"someone@mail.test", "demo", total=4, threshold=2,
                   verbose=False)
    assert len(json.loads(json.dumps(out))["output"]) > 0


def test_malformed_request_is_json_error():
    op = make_oprf_operator()
    keys = op.generate_threshold_keys(3, 2)
    srv = ShareServer(keys["shares"][0]).start()
    try:
        for path, body, code in (("/evaluate", {"maskedData": "AAAA"}, 400),
                                 ("/other", {}, 404)):
            req = urllib.request.Request(
                srv.url + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=10)
            assert e.value.code == code
            if code == 400:
                assert "error" in json.loads(e.value.read())
    finally:
        srv.shutdown()
        srv.server_close()

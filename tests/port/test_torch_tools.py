"""The port's tools (tools/*_torch.py): each parses --help; the two that
need the reference checkout exit non-zero and name the missing file;
gen_oneblock_artifacts_torch writes into the port's key store, never under
artifacts/ (only the path is checked: its setup is too costly here)."""
import importlib.util
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TOOLS = ("profile_prove_torch", "bench_stark_torch", "stwo_crosscheck_torch",
         "run_imported_r1cs_e2e_torch", "gen_oneblock_artifacts_torch")


def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", TOOLS)
def test_tool_parses_help(name, capsys):
    with pytest.raises(SystemExit) as e:
        load_tool(name).main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.startswith("usage: ") and "--device" in out


@pytest.mark.parametrize("name,missing", [
    ("run_imported_r1cs_e2e_torch", os.path.join("gnark", "r1cs.chacha20")),
    ("stwo_crosscheck_torch", os.path.join("stwo", "s2circuits_bg.wasm"))])
def test_reference_tools_name_the_missing_file(name, missing, tmp_path,
                                               monkeypatch, capsys):
    monkeypatch.setenv("ZKSC_REFERENCE_RESOURCES", str(tmp_path))
    assert load_tool(name).main([]) == 2
    assert os.path.join(str(tmp_path), missing) in capsys.readouterr().err


def test_reference_tool_exit_code_as_a_process(tmp_path):
    env = dict(os.environ, ZKSC_REFERENCE_RESOURCES=str(tmp_path))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "stwo_crosscheck_torch.py")],
        capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 2 and out.stdout == ""
    assert str(tmp_path) in out.stderr


def test_oneblock_keys_go_to_the_key_store():
    from zksc_tpu_torch.keygen import KEY_STORE
    out = load_tool("gen_oneblock_artifacts_torch").OUT_DIR
    assert out == os.path.join(KEY_STORE, "chacha20-1block")
    assert out.startswith(os.path.join(ROOT, "zksc_tpu_torch", "build",
                                       "artifacts") + os.sep)
    assert not out.startswith(os.path.join(ROOT, "artifacts") + os.sep)
    cache = load_tool("run_imported_r1cs_e2e_torch").CACHE
    assert os.path.dirname(cache) == KEY_STORE

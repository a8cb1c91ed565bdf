"""Disassemble the STARK kernels (csrc/stark_kernels.cu) as built for sm_90a.

Builds zksc_tpu_torch/build/libzksc_stark.so if needed, runs ``cuobjdump
-sass`` on it, and prints, for every kernel whose name holds one of the
given substrings, its instruction count and opcode histogram; with
--loops also each loop body's (the instructions from a backward branch's
target to the branch: K7a's compression loop). With --out the kernels' full
SASS is written there too. The instruction counts that chip_smoke.py's K7
bounds use per constraint term and per compression come from reading this
output. Needs nvcc and cuobjdump (the CUDA toolkit):

    python tools/stark_sass.py [--kernels composition] [--loops] [--out FILE]
"""
import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def functions(sass: str) -> dict:
    """{kernel name: [instruction lines]} from cuobjdump -sass output."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            out[name].append(line.strip())
    return out


def opcode(line: str) -> str:
    body = re.sub(r"^/\*[0-9a-f]{4}\*/\s*", "", line)
    body = re.sub(r"^@!?U?P\w+\s+", "", body)      # predicate guard
    return body.split()[0].rstrip(";") if body else ""


def loops(ins: list) -> list:
    """[(start, end, body)] for each backward branch in a kernel's
    instruction lines: body runs from the branch target to the branch."""
    addr = [int(re.match(r"/\*([0-9a-f]{4,})\*/", i).group(1), 16) for i in ins]
    out = []
    for k, line in enumerate(ins):
        m = re.search(r"\bBRA\s+(?:`\()?\.?L?\w*?(0x[0-9a-f]+)", line)
        if m and int(m.group(1), 16) < addr[k]:
            start = addr.index(int(m.group(1), 16))
            out.append((addr[start], addr[k], ins[start:k + 1]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="composition",
                    help="comma-separated substrings of kernel names")
    ap.add_argument("--loops", action="store_true",
                    help="also print each loop body's opcode histogram")
    ap.add_argument("--out", help="write the selected kernels' SASS here")
    a = ap.parse_args()
    from zksc_tpu_torch.ops import cuda_build
    cuda_build.build(["stark"])
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", cuda_build.lib_path("stark")],
                          check=True, capture_output=True, text=True).stdout
    keys = a.kernels.split(",")
    chosen = {n: ins for n, ins in functions(sass).items()
              if any(k in n for k in keys)}
    if not chosen:
        raise SystemExit(f"no kernel matches {keys}")
    for name, ins in chosen.items():
        hist = collections.Counter(opcode(i) for i in ins)
        print(f"{name}: {len(ins)} instructions")
        print("  " + ", ".join(f"{k} {v}" for k, v in hist.most_common()))
        for start, end, body in (loops(ins) if a.loops else []):
            hist = collections.Counter(opcode(i) for i in body)
            print(f"  loop {start:#x}-{end:#x}: {len(body)} instructions")
            print("    " + ", ".join(f"{k} {v}" for k, v in hist.most_common()))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            for name, ins in chosen.items():
                f.write(f"Function : {name}\n" + "\n".join(ins) + "\n\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Row lengths and coefficient classes of the Groth16 circuits' A, B and C
matrices, as K5 (the sparse mat-vec, ops/h_kernels.py) sees them.

    python3 tools/h_matrix_stats_torch.py [--algorithms chacha20 aes-128-ctr ...]

For each circuit (compiled by the port's r1cs, no keys needed) and each
matrix: its nonzeros, the rows in each length band, the longest row and
the share of the terms in rows of more than 32 terms; the coefficients by
class (+-1, +-c with c < 2^32 counted as min(c, r - c), +-2^s with s >= 32,
the rest); then the stacked CSR's bins (h_kernels.CSR: a thread's, a
warp's, a block's rows) and the term kinds it packs. Runs on the CPU.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from zksc_tpu_torch.fields.limb import Fr  # noqa: E402
from zksc_tpu_torch.operators import CircuitSpec  # noqa: E402
from zksc_tpu_torch.ops import h_kernels  # noqa: E402

BANDS = ((0, 0), (1, 1), (2, 16), (17, 32), (33, 1024), (1025, None))
KINDS = ("+1", "-1", "+c", "-c", "wide")


def coeff_class(c: int) -> str:
    m = min(c, Fr.p - c)
    if m == 1:
        return "+-1"
    if m < 1 << 32:
        return "+-c<2^32"
    if m & (m - 1) == 0:
        return "+-2^s,s>=32"
    return "other"


def matrix_stats(name: str, constraints, sel: int) -> tuple:
    lengths = np.array([len(lcs[sel]) for lcs in constraints])
    classes = {}
    for lcs in constraints:
        for c in lcs[sel].values():
            k = coeff_class(c % Fr.p)
            classes[k] = classes.get(k, 0) + 1
    nnz = int(lengths.sum())
    bands = []
    for lo, hi in BANDS:
        sel_rows = (lengths >= lo) & (lengths <= (hi if hi is not None
                                                  else lengths.max()))
        label = f"{lo}" if lo == hi else (f"{lo}-{hi}" if hi else f">{lo - 1}")
        bands.append(f"{label}: {int(sel_rows.sum())}")
    long_terms = int(lengths[lengths > 32].sum())
    print(f"  {name}: {nnz} nonzeros over {lengths.size} rows; rows by "
          f"terms {', '.join(bands)}; longest {int(lengths.max())}; "
          f"{long_terms} terms ({100 * long_terms / max(nnz, 1):.1f}%) in "
          f"rows over 32; coefficients {classes}", flush=True)
    return lengths


def circuit_stats(alg: str):
    t = time.time()
    cs = CircuitSpec(alg).cs
    print(f"{alg}: {len(cs.constraints)} constraints "
          f"(compiled in {time.time() - t:.1f} s)", flush=True)
    n = len(cs.constraints)
    mats = []
    for sel, name in enumerate("ABC"):
        matrix_stats(name, cs.constraints, sel)
        rows, cols, coeffs = [], [], []
        for k, lcs in enumerate(cs.constraints):
            for wire, coeff in lcs[sel].items():
                rows.append(k)
                cols.append(wire)
                coeffs.append(coeff)
        mats.append((torch.as_tensor(np.asarray(rows, dtype=np.int64)),
                     torch.as_tensor(np.asarray(cols, dtype=np.int64)),
                     Fr.to_device(coeffs, device="cpu")))
    csr = h_kernels.CSR.stack(mats, n)
    kinds = (csr.terms[:, 0].long() & 0xFFFFFFFF) >> h_kernels.TERM_KIND_SHIFT
    counts = torch.bincount(kinds, minlength=5).tolist()
    print(f"  stacked CSR: bins (a thread's <= {h_kernels.SHORT_ROW}, a "
          f"warp's <= {h_kernels.WARP_ROW}, a block's) {list(csr.bins)}; "
          f"term kinds {dict(zip(KINDS, counts))} "
          f"({time.time() - t:.1f} s)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--algorithms", nargs="+",
                    default=["chacha20", "aes-128-ctr", "chacha20-toprf"])
    args = ap.parse_args(argv)
    for alg in args.algorithms:
        circuit_stats(alg)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The PTX carry chains of zksc_tpu_torch/csrc/bn254.cuh, run on the CPU.

Each inline-asm block of the header's field core (mac4, shift_merge, sub8,
add8) is read from the source and executed by a small interpreter of the
PTX integer instructions it uses, with the carry flag as the PTX ISA
defines it (set by .cc, read by madc / addc / subc, a borrow for
subtraction; a mad/madc without .cc must not carry out). The loops of mont_mul / mod_add / mod_sub around the blocks are
mirrored here line for line; the results are held to Python integers on
edge and random operands, and to the port's own Montgomery product
(fields/limb.py), limb for limb, for both moduli the header's element
types name: p (Fp) and r (Fr). This is the arithmetic the K1/K2/K3 and
K0/K4/K5 kernels run on the card, checked where no CUDA compiler exists."""
import os
import random
import re

import pytest

from zksc_tpu_torch.fields.limb import BN254_P as P, BN254_R, Fp, Fr

HEADER = os.path.join(os.path.dirname(__file__), "..", "..", "zksc_tpu_torch",
                      "csrc", "bn254.cuh")
M32 = (1 << 32) - 1
R = 1 << 256
# -m^-1 mod 2^32 of each modulus, as the header's Field<E>::np0
NP0 = {P: 0xE4866389, BN254_R: 0xEFFFFFFF}


def _blocks():
    """{function name: (instructions, operand expressions)} of the header's
    asm blocks."""
    src = open(HEADER).read()
    out = {}
    for m in re.finditer(r"__forceinline__ \w+ (\w+)\(", src):
        body_end = src.find("\n}\n", m.end())
        j = src.find("asm volatile(", m.end(), body_end)
        if j < 0:
            continue
        k = src.index(");", j)
        parts = src[j + len("asm volatile("):k].split(":")
        tmpl = "".join(re.findall(r'"([^"]*)"', parts[0]))
        ops = []
        for part in parts[1:3]:
            ops += re.findall(r'"[=+]?r"\(([^)]*)\)', part)
        instrs = [s.strip() for s in tmpl.replace("\\n", "").replace("\\t", "")
                  .split(";") if s.strip()]
        out[m.group(1)] = (instrs, ops)
    return out


BLOCKS = _blocks()


def _run(fn: str, env: dict) -> dict:
    """Execute block `fn` on env (operand expression -> uint32)."""
    instrs, ops = BLOCKS[fn]
    cf = 0

    def val(tok):
        return env[ops[int(tok[1:])]] if tok.startswith("%") else int(tok, 0)

    for ins in instrs:
        op, args = ins.split(None, 1)
        args = [a.strip() for a in args.split(",")]
        s = [val(a) for a in args[1:]]
        parts = op.split(".")
        base, cc = parts[0], "cc" in parts
        if base in ("mad", "madc"):
            prod = s[0] * s[1]
            tot = ((prod >> 32) if "hi" in parts else prod & M32) + s[2] \
                + (cf if base == "madc" else 0)
            out_cf = tot >> 32
        elif base in ("add", "addc"):
            tot = s[0] + s[1] + (cf if base == "addc" else 0)
            out_cf = tot >> 32
        elif base in ("sub", "subc"):
            tot = s[0] - s[1] - (cf if base == "subc" else 0)
            out_cf = int(tot < 0)
        else:
            raise ValueError(f"{fn}: unexpected instruction {ins}")
        if not cc and base in ("mad", "madc") and out_cf:
            raise AssertionError(f"{fn}: carry lost at {ins}")
        env[ops[int(args[0][1:])]] = tot & M32
        if cc:
            cf = out_cf
    return env


def _words(x):
    return [(x >> (32 * i)) & M32 for i in range(8)]


def _int(w):
    return sum(v << (32 * i) for i, v in enumerate(w))




def _arr(name, vals):
    return {f"{name}[{i}]": v for i, v in enumerate(vals)}


def _get(env, name, n):
    return [env[f"{name}[{i}]"] for i in range(n)]


def _mac4(c, x, b):
    env = {**_arr("c", c), "x0": x[0], "x1": x[1], "x2": x[2], "x3": x[3],
           "b": b}
    return _get(_run("mac4", env), "c", 9)


def _sub8(a, b):
    env = _run("sub8", {**_arr("a", a), **_arr("b", b), "bw": 0})
    return _get(env, "d", 8), env["bw"]


def _add8(a, b):
    return _get(_run("add8", {**_arr("a", a), **_arr("b", b)}), "d", 8)


def _reduce_once(t, m):
    d, bw = _sub8(t, _words(m))
    return t if bw else d


def mont_mul(a, b, m=P):
    """bn254.cuh:mont_mul over the modulus m, its loop mirrored."""
    mw = _words(m)
    e = [0] * 9
    for i in range(8):
        o = [0] * 9
        e = _mac4(e, a[0::2], b[i])
        o = _mac4(o, a[1::2], b[i])
        q = (e[0] * NP0[m]) & M32
        e = _mac4(e, mw[0::2], q)
        assert e[0] == 0
        o = _mac4(o, mw[1::2], q)
        env = _run("shift_merge", {**_arr("e", e), **_arr("o", o)})
        e = _get(env, "e", 9)
        assert e[8] == 0 and _int(e[:8]) < 2 * m
    return _reduce_once(e[:8], m)


def mod_add(a, b, m=P):
    return _reduce_once(_add8(a, b), m)


def mod_sub(a, b, m=P):
    d, bw = _sub8(a, b)
    return _add8(d, [w & bw for w in _words(m)])


def _operands(n, seed, m=P):
    rnd = random.Random(seed)
    edge = [0, 1, 2, m - 1, m - 2, R % m, R * R % m, m // 2, 1 << 253]
    vals = edge + [rnd.randrange(m) for _ in range(n)]
    return [(x, y) for x in vals for y in (edge[3], edge[5], rnd.randrange(m))]


def test_np0_and_moduli_match_header():
    """The header's moduli, Montgomery ones and -m^-1 mod 2^32 are those of
    p and r."""
    src = open(HEADER).read()
    hexes = [int(h, 16) for h in re.findall(r"0x([0-9a-f]{8})u", src)]
    for m in (P, BN254_R):
        for v in (m, R % m):
            w = _words(v)
            assert any(hexes[i:i + 8] == w for i in range(len(hexes) - 7)), v
        assert (m * NP0[m] + 1) % (1 << 32) == 0
        assert f"0x{NP0[m]:08x}u" in src


def test_blocks_found():
    assert {"mac4", "shift_merge", "sub8", "add8"} <= set(BLOCKS)


def _check_core(op, m):
    rinv = pow(R, -1, m)
    for a, b in _operands(60, {"mul": 1, "add": 2, "sub": 3}[op], m):
        wa, wb = _words(a), _words(b)
        if op == "mul":
            assert _int(mont_mul(wa, wb, m)) == a * b * rinv % m, (a, b)
        elif op == "add":
            assert _int(mod_add(wa, wb, m)) == (a + b) % m, (a, b)
        else:
            assert _int(mod_sub(wa, wb, m)) == (a - b) % m, (a, b)


def _check_port_limbs(F):
    pairs = _operands(12, 4, F.p)
    xs = F.to_device([a for a, _ in pairs], mont=False)
    ys = F.to_device([b for _, b in pairs], mont=False)
    want = F.from_device(F.mont_mul(xs, ys), mont=False)
    got = [_int(mont_mul(_words(a), _words(b), F.p)) for a, b in pairs]
    assert got == want


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_field_core_vs_ints(op):
    _check_core(op, P)


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_fr_core_vs_ints(op):
    """The same chains over r, as the H kernels run them."""
    _check_core(op, BN254_R)


def test_fp_mul_vs_port_limbs():
    """The emulated product equals fields/limb.py's mont_mul limb for limb
    (16-bit limbs are the kernels' tensor boundary)."""
    _check_port_limbs(Fp)


def test_fr_mul_vs_port_limbs():
    """Over r: equal to Fr.mont_mul limb for limb."""
    _check_port_limbs(Fr)

"""Port vs reference: the gnark v0.14 R1CS import (zksc_tpu_torch.interop.
gnark_r1cs, cbor, intcomp vs zksc_tpu.interop's). The reference's own
.r1cs files are not in the checkout, so this file writes a small one by the
layout documented in gnark_r1cs.py: header and section lengths, levels and
instruction columns as intcomp streams (the u32 columns hold a packed
128-value block, one group of it zigzag-coded, plus a varint tail), LEB128
calldata, a CBOR trailer with tagged GenericR1C / GenericHint blueprints and
the hint table, and the Montgomery coefficient table. The circuit runs the
nBits hint, so solve_witness runs a hint. Both packages parse it, solve it
and convert it; the port then proves and verifies it on the CPU.

Tolerance: none (exact).
"""
import random
from collections import namedtuple

import numpy as np
import pytest

from zksc_tpu.interop import cbor as j_cbor
from zksc_tpu.interop import gnark_r1cs as jg
from zksc_tpu.interop import intcomp as j_ic
from zksc_tpu_torch.interop import cbor as t_cbor
from zksc_tpu_torch.interop import gnark_r1cs as tg
from zksc_tpu_torch.interop import intcomp as t_ic

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

R = jg.R

# ---------------------------------------------------------------------------
# A gnark v0.14 .r1cs writer: test scaffolding, the inverse of the parser.

Tag = namedtuple("Tag", "tag value")


def _cbor_head(major: int, n: int) -> bytes:
    if n < 24:
        return bytes([major << 5 | n])
    for ai, size in ((24, 1), (25, 2), (26, 4), (27, 8)):
        if n < 1 << (8 * size):
            return bytes([major << 5 | ai]) + n.to_bytes(size, "big")
    raise ValueError("CBOR head too large")


def cbor_encode(o) -> bytes:
    if o is False or o is True or o is None:
        return {False: b"\xf4", True: b"\xf5", None: b"\xf6"}[o]
    if isinstance(o, Tag):
        return _cbor_head(6, o.tag) + cbor_encode(o.value)
    if isinstance(o, int):
        return _cbor_head(0, o) if o >= 0 else _cbor_head(1, -1 - o)
    if isinstance(o, bytes):
        return _cbor_head(2, len(o)) + o
    if isinstance(o, str):
        b = o.encode()
        return _cbor_head(3, len(b)) + b
    if isinstance(o, list):
        return _cbor_head(4, len(o)) + b"".join(cbor_encode(v) for v in o)
    if isinstance(o, dict):
        return _cbor_head(5, len(o)) + b"".join(
            cbor_encode(k) + cbor_encode(v) for k, v in o.items())
    raise TypeError(type(o))


def leb128(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def intcomp_encode(values, word_bits: int) -> list:
    """values -> intcomp stream words: bit-packed blocks of 4 groups x
    word_bits deltas (zigzag where a group has a negative delta, width 0
    where all are zero), then a varint tail; a bare tail without blocks."""
    vals = [int(v) for v in values]
    lanes = word_bits
    block = 4 * lanes
    wmask = (1 << word_bits) - 1
    n_packed = len(vals) // block * block
    blocks = []
    for b0 in range(0, n_packed, block):
        hdr, payload = 0, []
        for g in range(4):
            lo = b0 + g * lanes
            d = [vals[i] - (vals[i - 1] if i else vals[0])
                 for i in range(lo, lo + lanes)]
            zz = any(x < 0 for x in d)
            if zz:
                d = [2 * x if x >= 0 else -2 * x - 1 for x in d]
            width = max(d).bit_length()
            hdr |= ((0x80 if zz else 0) | width) << (8 * (3 - g))
            acc = sum(x << (j * width) for j, x in enumerate(d))
            payload += [(acc >> (k * word_bits)) & wmask for k in range(width)]
        blocks += [hdr] + payload
    rem = vals[n_packed:]
    tail = []
    if rem or not n_packed:
        deltas = [rem[0]] + [(rem[i] - rem[i - 1]) & wmask
                             for i in range(1, len(rem))] if rem else []
        raw = b"".join(leb128(d) for d in deltas)
        nb = word_bits // 8
        raw += bytes(-len(raw) % nb)
        data = [int.from_bytes(raw[i:i + nb], "big")
                for i in range(0, len(raw), nb)]
        if word_bits == 32:
            T = 2 + len(data)
            tail = [len(rem), T] + data + [T]
        else:
            T = 1 + len(data)
            tail = [len(rem) | T << 32] + data + [T]
        if not rem:
            tail = [0, 2]               # empty: tailCount 0 (one word read)
    if not n_packed:
        return tail
    head = [n_packed, 0, vals[0]] if word_bits == 32 else [n_packed, vals[0]]
    tail_off = len(head) + len(blocks)
    if word_bits == 32:
        head[1] = tail_off
    else:
        head[0] |= tail_off << 32
    return head + blocks + (tail or [tail_off])


def _stream(values, word_bits: int) -> bytes:
    words = intcomp_encode(values, word_bits)
    dt = "<u4" if word_bits == 32 else "<u8"
    return len(words).to_bytes(8, "little") + np.asarray(
        words, dtype=np.uint64).astype(dt).tobytes()


def toy_r1cs(n_chain: int = 6, n_checks: int = 110):
    """A gnark v0.14 R1CS of Y = X^(n_chain+1) + 5 with X an 8-bit secret:
    an nBits hint splits X into bits (booleanity and recomposition
    constrained), a chain of products, one unknown in the L slot and one in
    the R slot, a final check with a -1 coefficient, and n_checks more
    booleanity checks that add no wire (so that the instruction columns
    reach a packed block while the key stays small). Returns (bytes,
    x -> (public, secret) assignment)."""
    X, Y, B0 = 2, 1, 3
    t = lambda j: 10 + j                     # t_j = X^(j+1), j = 1..n_chain
    u, v = 11 + n_chain, 12 + n_chain
    coeffs = [0, 1, 2, 4, 8, 16, 32, 64, 128, 5, R - 1]
    c1, c5, cm1 = 1, 9, 10
    recs, kinds = [], []

    def r1c(L, Rt, O):
        body = [len(L), len(Rt), len(O)]
        for lc in (L, Rt, O):
            for c, w in lc:
                body += [c, w]
        recs.append([1 + len(body)] + body)
        kinds.append(0)

    body = [jg.HINT_NBITS, 1, 1, c1, X, B0, B0 + 8]
    recs.append([1 + len(body)] + body)
    kinds.append(1)
    for k in range(8):
        r1c([(c1, B0 + k)], [(c1, B0 + k)], [(c1, B0 + k)])
    r1c([(1 + k, B0 + k) for k in range(8)], [(c1, 0)], [(c1, X)])
    r1c([(c1, X)], [(c1, X)], [(c1, t(1))])
    for j in range(2, n_chain + 1):
        r1c([(c1, t(j - 1))], [(c1, X)], [(c1, t(j))])
    r1c([(c1, u)], [(c1, X)], [(c1, t(1))])          # u = X, solved in L
    r1c([(c1, X)], [(c1, v)], [(c1, t(2))])          # v = X^2, solved in R
    r1c([(c1, t(n_chain)), (c5, 0), (cm1, u), (c1, X)], [(c1, 0)],
        [(c1, Y)])
    for k in range(n_checks):                        # 2b * b = 2b
        b = B0 + k % 8
        r1c([(2, b)], [(c1, b)], [(2, b)])
    n_instr = len(recs)
    calldata = [x for rec in recs for x in rec]
    starts = np.cumsum([0] + [len(r) for r in recs[:-1]]).tolist()
    con_off = np.cumsum([0] + [1 - k for k in kinds[:-1]]).tolist()
    wire_off = np.cumsum([0, 8] + [1] * (n_instr - 2)).tolist()

    levels = [[0], list(range(1, 10)), list(range(10, n_instr))]
    s1 = len(levels).to_bytes(8, "little") + b"".join(
        _stream(lv, 32) for lv in levels)
    s2 = (_stream(kinds, 32) + _stream(con_off, 32) + _stream(wire_off, 32)
          + _stream(starts, 64))
    s3 = len(calldata).to_bytes(8, "little") + b"".join(
        leb128(x) for x in calldata)
    s4 = cbor_encode({
        "GnarkVersion": "0.14.0",
        "ScalarField": format(R, "x"),
        "NbConstraints": n_instr - 1,
        "NbInternalVariables": 8 + n_chain + 2,
        "Public": ["1", "Y"],
        "Secret": ["X"],
        "Blueprints": [Tag(jg.TAG_GENERIC_R1C, {}),
                       Tag(jg.TAG_GENERIC_HINT, {"Fn": False})],
        "MHintsDependencies": {jg.HINT_NBITS: "std/math/bits.nBits"},
        "Levels": None,
    })
    mont = (1 << 256) % R
    table = len(coeffs).to_bytes(8, "little") + b"".join(
        (c * mont % R).to_bytes(32, "little") for c in coeffs)
    body = (b"".join(x.to_bytes(8, "little") for x in (0, 14, 0))
            + b"".join(len(s).to_bytes(8, "little") for s in (s1, s2, s3, s4))
            + s1 + s2 + s3 + s4 + table)
    data = (len(body) + 8 - 32).to_bytes(8, "little") + body

    def assignment(x: int):
        return {"Y": (pow(x, n_chain + 1, R) + 5) % R}, {"X": x}

    return data, assignment


# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy():
    data, assign = toy_r1cs()
    return data, assign, jg.parse_r1cs(data), tg.parse_r1cs(data)


def _packed_header_ok(words, word_bits):
    """The stream opens with a packed block (not a bare tail)."""
    block = 4 * word_bits
    n = words[0] if word_bits == 32 else words[0] & 0xFFFFFFFF
    return n > 0 and n % block == 0


def test_toy_file_reaches_packed_block_and_hint(toy):
    data, _, jc, tc = toy
    assert tc.n_instructions >= 128
    s1 = int.from_bytes(data[32:40], "little")
    off2 = 64 + s1                     # the BlueprintID column's stream
    nw = int.from_bytes(data[off2:off2 + 8], "little")
    words = np.frombuffer(data, "<u4", count=nw, offset=off2 + 8).tolist()
    assert _packed_header_ok(words, 32)
    assert words[3] >> 31 == 1          # group 0 is zigzag-coded
    kinds = [k for k, _ in tc.instructions()]
    assert kinds.count("hint") == 1 and kinds[0] == "hint"
    assert tc.hint_record(next(r for k, r in tc.instructions()
                               if k == "hint"))[0] == tg.HINT_NBITS


def test_parse_equal_fields(toy):
    _, _, jc, tc = toy
    for f in ("gnark_version", "nb_constraints", "nb_public", "nb_secret",
              "nb_internal", "public_names", "secret_names", "coefficients",
              "blueprint_tags", "hint_names", "commitment_info"):
        assert getattr(tc, f) == getattr(jc, f), f
    for f in ("blueprint_ids", "constraint_offsets", "wire_offsets",
              "call_starts", "calldata"):
        a, b = getattr(jc, f), getattr(tc, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert len(tc.levels) == len(jc.levels) == 3
    for a, b in zip(jc.levels, tc.levels):
        assert np.array_equal(a, b)
    assert tc.nb_constraints == sum(1 for k, _ in tc.instructions()
                                    if k == "r1c")
    is_r1c = np.array([k == "r1c" for k, _ in tc.instructions()])
    assert np.array_equal(tc.constraint_offsets,
                          np.concatenate([[0], np.cumsum(is_r1c)[:-1]]))


def test_parse_rejects_malformed(toy):
    data = toy[0]
    for bad in (data[:40], data[:-1], data[:8] + (1).to_bytes(8, "little")
                + data[16:]):
        for mod in (jg, tg):
            with pytest.raises(mod.GnarkR1CSError):
                mod.parse_r1cs(bad)


@pytest.mark.parametrize("word_bits", [32, 64])
def test_intcomp_streams_equal(word_bits):
    rng = random.Random(word_bits)
    block = 4 * word_bits
    dec = {32: (j_ic.decompress_uint32, t_ic.decompress_uint32),
           64: (j_ic.decompress_uint64, t_ic.decompress_uint64)}[word_bits]
    top = (1 << (word_bits - 1)) - 1      # zigzag deltas fit a word
    cases = [[], [7], [rng.randrange(top) for _ in range(5)],
             list(range(block)),
             sorted(rng.randrange(1 << 20) for _ in range(block + 9)),
             [rng.randrange(top) for _ in range(2 * block + 3)],
             [0] * block + [3] * 40]
    for vals in cases:
        words = np.asarray(intcomp_encode(vals, word_bits), dtype=np.uint64)
        words = words.astype(np.uint32 if word_bits == 32 else np.uint64)
        got = [f(words) for f in dec]
        assert got[1][1] == got[0][1] == (len(words) if vals else 1)
        assert np.array_equal(got[0][0], got[1][0])
        assert got[1][0].tolist() == vals
        assert _packed_header_ok(words.tolist(), word_bits) == (
            len(vals) >= block)


def test_cbor_decode_equal():
    obj = {"a": [1, -5, 2**40, b"\x00\x01", "txt", True, False, None],
           7: Tag(99, {"x": [Tag(5309736, {})]}), "big": 2**63 + 1}
    data = cbor_encode(obj) + b"tail"
    jv, jend = j_cbor.decode(data)
    tv, tend = t_cbor.decode(data)
    assert jend == tend == len(data) - 4
    assert repr(jv) == repr(tv)
    assert tv["a"] == [1, -5, 2**40, b"\x00\x01", "txt", True, False, None]
    assert tv[7].tag == 99 and tv[7].value["x"][0].tag == 5309736
    for bad in (b"\x9f", b"\xfc", b"\x82\x01"):
        for mod in (j_cbor, t_cbor):
            with pytest.raises(mod.CBORError):
                mod.decode(bad)


def test_solve_and_check_equal(toy):
    _, assign, jc, tc = toy
    for x in (2, 93, 255):
        pub, sec = assign(x)
        wj = jc.solve_witness(pub, sec)
        wt = tc.solve_witness(pub, sec)
        assert wt == wj
        assert wt[2] == x and wt[3:11] == [(x >> k) & 1 for k in range(8)]
        assert tc.check_witness(wt) and jc.check_witness(wj)
        bad = list(wt)
        bad[13] = (bad[13] + 1) % R         # t_3
        assert not tc.check_witness(bad) and not jc.check_witness(bad)
    pub, sec = assign(77)
    pub["Y"] = (pub["Y"] + 1) % R                  # a wrong output
    for cs, mod in ((jc, jg), (tc, tg)):
        with pytest.raises(mod.GnarkR1CSError, match="unsatisfied"):
            cs.solve_witness(pub, sec)
        with pytest.raises(mod.GnarkR1CSError, match="missing"):
            cs.solve_witness({}, sec)


def test_to_constraint_system_equal(toy):
    _, _, jc, tc = toy
    jcs, tcs = jc.to_constraint_system(), tc.to_constraint_system()
    assert type(tcs).__module__ == "zksc_tpu_torch.r1cs.builder"
    assert (tcs.n_public, tcs.n_wires) == (jcs.n_public, jcs.n_wires) == (1, 19)
    assert tcs.constraints == jcs.constraints
    assert tcs.digest() == jcs.digest()


def test_port_proves_imported_circuit_on_cpu(toy):
    from zksc_tpu_torch.curve import bn254_host as host
    from zksc_tpu_torch.groth16 import ProverContext, setup, verify
    _, assign, _, tc = toy
    cs = tc.to_constraint_system()
    rng = random.Random(12)
    pk, vk = setup(cs, rng=lambda: rng.randrange(2, host.R), device="cpu")
    pub, sec = assign(201)
    w = tc.solve_witness(pub, sec)
    # the bucket MSMs: on the CPU the plain 254-bit ladders of the default
    # route for so small a key take twice as long
    ctx = ProverContext(cs, pk, device="cpu", force_pippenger=True)
    proof = ctx.prove(np.asarray(w, dtype=object),
                      rng=lambda: rng.randrange(host.R))
    assert verify(vk, proof, [pub["Y"]])
    assert not verify(vk, proof, [(pub["Y"] + 1) % R])

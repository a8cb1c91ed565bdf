"""Minimal CBOR (RFC 8949) decoder for gnark constraint-system trailers.

gnark v0.14 serializes the small fields of a constraint system (version,
scalar field, variable names, blueprint registry, hint table) as a CBOR map
via fxamacker/cbor (reference: the trailer section of
the reference checkout's resources/gnark/r1cs.* as written by gnark's
constraint.System serialization — SURVEY.md §2.5 item 8). Only the subset of
CBOR that gnark emits is supported: unsigned/negative ints, byte/text
strings, arrays, maps, tags, false/true/null.
"""
from __future__ import annotations

import struct

__all__ = ["decode", "CBORTag", "CBORError"]


class CBORError(ValueError):
    pass


class CBORTag:
    __slots__ = ("tag", "value")

    def __init__(self, tag: int, value):
        self.tag = tag
        self.value = value

    def __repr__(self):
        return f"CBORTag({self.tag}, {self.value!r})"


def decode(data: bytes, offset: int = 0):
    """Decode one CBOR item starting at `offset`.

    Returns (value, end_offset)."""
    return _decode(data, offset)


def _decode(d: bytes, off: int):
    if off >= len(d):
        raise CBORError("truncated CBOR")
    ib = d[off]
    mt, ai = ib >> 5, ib & 31
    off += 1
    if ai < 24:
        val = ai
    elif ai == 24:
        val = d[off]; off += 1
    elif ai == 25:
        (val,) = struct.unpack_from(">H", d, off); off += 2
    elif ai == 26:
        (val,) = struct.unpack_from(">I", d, off); off += 4
    elif ai == 27:
        (val,) = struct.unpack_from(">Q", d, off); off += 8
    elif ai == 31:
        raise CBORError("indefinite-length items not emitted by gnark")
    else:
        raise CBORError(f"reserved additional info {ai}")

    if mt == 0:
        return val, off
    if mt == 1:
        return -1 - val, off
    if mt == 2:
        return bytes(d[off:off + val]), off + val
    if mt == 3:
        return d[off:off + val].decode("utf-8"), off + val
    if mt == 4:
        out = []
        for _ in range(val):
            item, off = _decode(d, off)
            out.append(item)
        return out, off
    if mt == 5:
        out = {}
        for _ in range(val):
            k, off = _decode(d, off)
            v, off = _decode(d, off)
            out[k] = v
        return out, off
    if mt == 6:
        inner, off = _decode(d, off)
        return CBORTag(val, inner), off
    # mt == 7: simple values / floats
    if ai == 20:
        return False, off
    if ai == 21:
        return True, off
    if ai == 22:
        return None, off
    if ai == 27:
        return struct.unpack_from(">d", d, off - 8)[0], off
    raise CBORError(f"unsupported simple/float item (ai={ai})")

"""Parser for gnark v0.14 R1CS binary files + a witness solver.

Imports the reference's exact constraint systems (the reference checkout's
resources/gnark/r1cs.{chacha20,aes128,aes256}, written by
gnark/keygen/keygen.go:66-92 via constraint.System serialization and loaded
by gnark/libraries/prover/impl/library.go:105-133) so witnesses generated by
this framework can be checked — and proofs produced — against bit-exactly
the same R1CS the reference gnark engine uses (SURVEY.md §2.5 items 3, 8).
The JAX package's ``interop/gnark_r1cs.py``; ``to_constraint_system`` builds
the port's ConstraintSystem, so an imported circuit goes through the port's
``groth16.setup`` and ``ProverContext`` on the card.

File layout (all little-endian; format reverse-engineered from the shipped
artifacts and validated value-exactly against internal cross-checks —
CallData record lengths == StartCallData deltas, R1C/hint record counts ==
NbConstraints/BlueprintID columns, name counts == CBOR arrays):

  u64 bodyLen                      total bytes after this word
  u64 major, u64 minor, u64 patch  gnark version (0, 14, 0)
  u64 s1, s2, s3, s4               byte lengths of the 4 sections
  section 1  Levels:  u64 nLevels, then per level
             {u64 nWords, intcomp-u32 stream of instruction ids}
  section 2  Instructions (struct-of-arrays, one stream per column):
             {u64 nWords, intcomp-u32}  BlueprintID
             {u64 nWords, intcomp-u32}  ConstraintOffset (exclusive prefix)
             {u64 nWords, intcomp-u32}  WireOffset (exclusive prefix)
             {u64 nWords, intcomp-u64}  StartCallData
  section 3  CallData: u64 nValues, LEB128 varints (one u32 each)
  section 4  CBOR map: GnarkVersion, ScalarField, NbConstraints,
             NbInternalVariables, Public/Secret names, Blueprints (tagged),
             MHintsDependencies, CommitmentInfo, ...
  trailer    Coefficient table: u64 count, count x 32-byte fr.Element
             (little-endian Montgomery form)

CallData record layouts (per blueprint):
  GenericR1C  [recLen, lenL, lenR, lenO, (coeffID, wireID) x terms]
              recLen counts the whole record including itself
  GenericHint [recLen, hintID, nbInputs,
               per input: nbTerms, (coeffID, wireID) x nbTerms,
               firstOutputWire, outputEndWire]  (half-open output range)

Wire numbering: 0 = the constant one wire, [1, nbPublic) = public inputs,
[nbPublic, nbPublic+nbSecret) = secret inputs, then internal wires.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from . import cbor
from .intcomp import decompress_uint32, decompress_uint64

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
_R_MONT = (1 << 256) % R
_R_MONT_INV = pow(_R_MONT, -1, R)

# CBOR tags gnark registers for its blueprint types (observed in the
# reference artifacts; chacha uses the first two, aes adds lookup tables)
TAG_GENERIC_HINT = 5309735
TAG_GENERIC_R1C = 5309736
TAG_LOOKUP_HINT = 5309748

HINT_NBITS = 4115454955          # std/math/bits.nBits
HINT_RANDOMIZE = 1774611027      # internal/hints.Randomize
HINT_LOGDERIV_COUNT = 2138922168  # std/internal/logderivarg.countHint
HINT_COMMITMENT = 4156202267     # cs.Bsb22CommitmentComputePlaceholder


class GnarkR1CSError(ValueError):
    pass


@dataclass
class GnarkR1CS:
    gnark_version: str
    nb_constraints: int
    nb_public: int               # includes the constant-one wire
    nb_secret: int
    nb_internal: int
    public_names: list
    secret_names: list
    coefficients: list           # plain ints mod R
    blueprint_tags: list         # CBOR tag per blueprint id
    blueprint_ids: np.ndarray    # [n_instr] uint32
    constraint_offsets: np.ndarray
    wire_offsets: np.ndarray
    call_starts: np.ndarray      # [n_instr] uint64 offsets into calldata
    calldata: np.ndarray         # uint32 values
    levels: list = field(default_factory=list)
    hint_names: dict = field(default_factory=dict)
    commitment_info: list = field(default_factory=list)

    @property
    def n_wires(self) -> int:
        return self.nb_public + self.nb_secret + self.nb_internal

    @property
    def n_instructions(self) -> int:
        return len(self.blueprint_ids)

    # ---- constraint iteration ----

    def instructions(self):
        """Yield (kind, record) per instruction in creation order.
        kind: 'r1c' | 'hint' | 'lookup'. record: the calldata slice."""
        cd = self.calldata
        for i in range(self.n_instructions):
            s = int(self.call_starts[i])
            n = int(cd[s])
            rec = cd[s:s + n]
            tag = self.blueprint_tags[int(self.blueprint_ids[i])]
            if tag == TAG_GENERIC_R1C:
                yield "r1c", rec
            elif tag == TAG_GENERIC_HINT:
                yield "hint", rec
            elif tag == TAG_LOOKUP_HINT:
                yield "lookup", rec
            else:
                raise GnarkR1CSError(f"unknown blueprint tag {tag}")

    def r1c_terms(self, rec) -> tuple:
        """Split an r1c record into (L, R, O) term lists of (coeff, wire)."""
        ln_l, ln_r, ln_o = int(rec[1]), int(rec[2]), int(rec[3])
        coeffs = self.coefficients
        p = 4
        out = []
        for ln in (ln_l, ln_r, ln_o):
            terms = [(coeffs[int(rec[p + 2 * t])], int(rec[p + 2 * t + 1]))
                     for t in range(ln)]
            p += 2 * ln
            out.append(terms)
        return tuple(out)

    def hint_record(self, rec) -> tuple:
        """(hint_id, inputs [list of term lists], (out_first, out_end)).
        The output wire range is half-open: [out_first, out_end)."""
        hint_id = int(rec[1])
        nb_in = int(rec[2])
        p = 3
        coeffs = self.coefficients
        inputs = []
        for _ in range(nb_in):
            nt = int(rec[p]); p += 1
            inputs.append([(coeffs[int(rec[p + 2 * t])], int(rec[p + 2 * t + 1]))
                           for t in range(nt)])
            p += 2 * nt
        out_first, out_last = int(rec[p]), int(rec[p + 1])
        return hint_id, inputs, (out_first, out_last)

    # ---- witness solving (gnark's per-instruction solve order) ----

    def solve_witness(self, public: dict, secret: dict,
                      hints: dict | None = None) -> list:
        """Solve the full wire vector from named inputs.

        public/secret: name -> int value (names from public_names /
        secret_names; the constant '1' wire is implicit). Returns the wire
        vector [n_wires] of plain ints mod R. Mirrors gnark's R1CS solver:
        instructions run in creation order; each R1C determines its single
        unknown wire; hints compute their outputs natively."""
        w = [None] * self.n_wires
        w[0] = 1
        for i, name in enumerate(self.public_names):
            if i == 0:
                continue
            if name not in public:
                raise GnarkR1CSError(f"missing public input {name}")
            w[i] = int(public[name]) % R
        for j, name in enumerate(self.secret_names):
            if name not in secret:
                raise GnarkR1CSError(f"missing secret input {name}")
            w[self.nb_public + j] = int(secret[name]) % R

        hint_impls = dict(_BUILTIN_HINTS)
        if hints:
            hint_impls.update(hints)

        def ev(terms):
            acc = 0
            unknown = None
            for c, wi in terms:
                v = w[wi]
                if v is None:
                    if unknown is not None:
                        raise GnarkR1CSError("two unknowns in one LC")
                    unknown = (c, wi)
                else:
                    acc += c * v
            return acc % R, unknown

        for kind, rec in self.instructions():
            if kind == "r1c":
                L, Rt, O = self.r1c_terms(rec)
                lv, lu = ev(L)
                rv, ru = ev(Rt)
                ov, ou = ev(O)
                unknowns = [u for u in (lu, ru, ou) if u is not None]
                if not unknowns:
                    if (lv * rv - ov) % R != 0:
                        raise GnarkR1CSError("unsatisfied constraint while solving")
                    continue
                if len(set(u[1] for u in unknowns)) > 1:
                    raise GnarkR1CSError("R1C with multiple unknown wires")
                c, wi = unknowns[0]
                if ou is not None and lu is None and ru is None:
                    # L*R = ov + c*x
                    x = (lv * rv - ov) * pow(c, -1, R) % R
                elif lu is not None and ru is None and ou is None:
                    # (lv + c x) * rv = ov
                    x = (ov - lv * rv) * pow(c * rv % R, -1, R) % R
                elif ru is not None and lu is None and ou is None:
                    x = (ov - lv * rv) * pow(c * lv % R, -1, R) % R
                else:
                    raise GnarkR1CSError("unknown wire in multiple slots")
                w[wi] = x
            elif kind == "hint":
                hint_id, inputs, (of, ol) = self.hint_record(rec)
                impl = hint_impls.get(hint_id)
                if impl is None:
                    name = self.hint_names.get(hint_id, hex(hint_id))
                    raise GnarkR1CSError(f"no implementation for hint {name}")
                in_vals = []
                for terms in inputs:
                    v, u = ev(terms)
                    if u is not None:
                        raise GnarkR1CSError("hint input with unknown wire")
                    in_vals.append(v)
                outs = impl(in_vals, ol - of)
                for k, v in enumerate(outs):
                    w[of + k] = int(v) % R
            else:
                raise GnarkR1CSError(
                    "lookup blueprints need table state; use check_witness "
                    "for aes circuits")
        for i, v in enumerate(w):
            if v is None:
                w[i] = 0
        return w

    def check_witness(self, w) -> bool:
        """True iff every R1C constraint is satisfied by wire vector w."""
        for kind, rec in self.instructions():
            if kind != "r1c":
                continue
            L, Rt, O = self.r1c_terms(rec)

            def ev(terms):
                return sum(c * int(w[wi]) for c, wi in terms) % R

            if (ev(L) * ev(Rt) - ev(O)) % R != 0:
                return False
        return True

    def to_constraint_system(self):
        """Convert to the port's ConstraintSystem (COO sparse A/B/C) for
        proving with its Groth16 pipeline. Wire order is preserved:
        [one | publics | secrets | internals], which is already the
        [1 | public | private] order our prover expects."""
        from ..r1cs.builder import ConstraintSystem
        constraints = []
        for kind, rec in self.instructions():
            if kind != "r1c":
                continue
            L, Rt, O = self.r1c_terms(rec)
            constraints.append((
                {wi: c for c, wi in L},
                {wi: c for c, wi in Rt},
                {wi: c for c, wi in O},
            ))
        return ConstraintSystem(
            n_public=self.nb_public - 1,
            n_wires=self.n_wires,
            constraints=constraints,
        )


def _nbits_hint(in_vals, n_out):
    v = in_vals[0]
    return [(v >> k) & 1 for k in range(n_out)]


_BUILTIN_HINTS = {
    HINT_NBITS: _nbits_hint,
}


def parse_r1cs(data: bytes | str) -> GnarkR1CS:
    """Parse a gnark v0.14 R1CS binary (path or bytes)."""
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    if len(data) < 64:
        raise GnarkR1CSError("file too short")
    (body_len, major, minor, patch,
     s1, s2, s3, s4) = struct.unpack_from("<8Q", data, 0)
    if body_len != len(data) - 32:
        raise GnarkR1CSError("body length mismatch")
    if (major, minor) != (0, 14):
        raise GnarkR1CSError(f"unsupported gnark version {major}.{minor}.{patch}")

    off1 = 64
    off2 = off1 + s1
    off3 = off2 + s2
    off4 = off3 + s3
    off5 = off4 + s4

    # section 1: levels
    (n_levels,) = struct.unpack_from("<Q", data, off1)
    levels = []
    p = off1 + 8
    for _ in range(n_levels):
        (nw,) = struct.unpack_from("<Q", data, p)
        words = np.frombuffer(data, dtype="<u4", count=nw, offset=p + 8)
        vals, used = decompress_uint32(words)
        if used != nw:
            raise GnarkR1CSError("level stream length mismatch")
        levels.append(vals.astype(np.uint32))
        p += 8 + 4 * nw
    if p != off2:
        raise GnarkR1CSError("levels section length mismatch")

    # section 2: instruction columns
    p = off2
    cols = []
    for dtype, dec in (("<u4", decompress_uint32), ("<u4", decompress_uint32),
                       ("<u4", decompress_uint32), ("<u8", decompress_uint64)):
        (nw,) = struct.unpack_from("<Q", data, p)
        itemsize = 4 if dtype == "<u4" else 8
        words = np.frombuffer(data, dtype=dtype, count=nw, offset=p + 8)
        vals, used = dec(words)
        if used != nw:
            raise GnarkR1CSError("instruction column length mismatch")
        cols.append(vals)
        p += 8 + itemsize * nw
    if p != off3:
        raise GnarkR1CSError("instructions section length mismatch")
    blueprint_ids, constraint_offsets, wire_offsets, call_starts = cols

    # section 3: calldata varints
    (n_calldata,) = struct.unpack_from("<Q", data, off3)
    calldata = _decode_varints_np(
        np.frombuffer(data, dtype=np.uint8,
                      count=off4 - off3 - 8, offset=off3 + 8), n_calldata)

    # section 4: CBOR trailer
    obj, cbor_end = cbor.decode(data, off4)
    if not isinstance(obj, dict):
        raise GnarkR1CSError("CBOR trailer is not a map")

    # coefficient table
    (n_coeffs,) = struct.unpack_from("<Q", data, cbor_end)
    coeffs = []
    cp = cbor_end + 8
    for _ in range(n_coeffs):
        mont = int.from_bytes(data[cp:cp + 32], "little")
        coeffs.append(mont * _R_MONT_INV % R)
        cp += 32

    field_hex = obj.get("ScalarField", "")
    if int(field_hex, 16) != R:
        raise GnarkR1CSError("not a BN254 scalar-field system")

    tags = []
    for bp in obj.get("Blueprints", []):
        if not isinstance(bp, cbor.CBORTag):
            raise GnarkR1CSError("untagged blueprint entry")
        tags.append(bp.tag)

    return GnarkR1CS(
        gnark_version=obj.get("GnarkVersion", f"{major}.{minor}.{patch}"),
        nb_constraints=obj["NbConstraints"],
        nb_public=len(obj["Public"]),
        nb_secret=len(obj["Secret"]),
        nb_internal=obj["NbInternalVariables"],
        public_names=obj["Public"],
        secret_names=obj["Secret"],
        coefficients=coeffs,
        blueprint_tags=tags,
        blueprint_ids=blueprint_ids.astype(np.uint32),
        constraint_offsets=constraint_offsets.astype(np.uint32),
        wire_offsets=wire_offsets.astype(np.uint32),
        call_starts=call_starts,
        calldata=calldata,
        levels=levels,
        hint_names=obj.get("MHintsDependencies") or {},
        commitment_info=(obj.get("CommitmentInfo").value
                         if isinstance(obj.get("CommitmentInfo"), cbor.CBORTag)
                         else obj.get("CommitmentInfo") or []),
    )


def _decode_varints_np(b: np.ndarray, count: int) -> np.ndarray:
    """Vectorized LEB128 decode of `count` uint32 values."""
    cont = b >= 0x80
    ends = np.nonzero(~cont)[0]
    if len(ends) < count:
        raise GnarkR1CSError("calldata varint stream truncated")
    ends = ends[:count]
    starts = np.concatenate([[0], ends[:-1] + 1])
    lengths = ends - starts + 1
    if lengths.max(initial=1) > 5:
        raise GnarkR1CSError("calldata varint wider than u32")
    payload = (b & 0x7F).astype(np.uint64)
    out = np.zeros(count, dtype=np.uint64)
    for k in range(int(lengths.max(initial=1))):
        sel = lengths > k
        out[sel] |= payload[starts[sel] + k] << np.uint64(7 * k)
    return out.astype(np.uint32)

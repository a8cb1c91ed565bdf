"""In-circuit TOPRF verification gadget (BabyJubJub + MiMC over BN254 Fr).

R1CS port of the reference's gnark TOPRF gadget (behavior studied at
gnark/circuits/toprf/toprf.go:38-221 — VerifyTOPRF, ExtractSecretElements,
verifyDLEQ, hashToPoint, clearCofactor; re-implemented fresh on our builder):

  - secret-element extraction from cipher output bits via a public bitmask
    and length (pow1/pow2 accumulators that only advance on masked bits, so
    the packed elements are little-endian over the selected bytes — matching
    the host side's BEtoLE encoding, oprf/oprf.py)
  - hash-to-point H = [MiMC(s0, s1, domain)]Base
  - per-share DLEQ verification over cofactor-cleared points
  - Lagrange recombination of responses with public coefficients
  - unmasking by the inverse of the private mask — the inverse is HINTED and
    bound by an in-circuit non-native check mask * inv == 1 (mod l) (the
    reference reaches the same result via gnark's emulated-field Inverse;
    a hint + product check is the cheaper equivalent)
  - output binding MiMC(x, y, s0, s1) == Output

BabyJubJub arithmetic is native here because the curve lives over BN254 Fr —
the same trick the reference exploits. Complete twisted-Edwards addition:
denominators are hinted and bound by mul_eq, 7 constraints per add.
"""
from __future__ import annotations

from ..builder import Var
from ...oprf import babyjubjub as bjj
from ...oprf.mimc import CONSTANTS as MIMC_CONSTANTS

Q = bjj.Q                   # BN254 Fr — the circuit field
A = bjj.A
D = bjj.D
L = bjj.L_ORDER             # BabyJub prime subgroup order
SCALAR_BITS = 254
BYTES_PER_ELEMENT = 31
THRESHOLD = 1               # reference toprf.go:16

_HALF = 127                 # limb split for the non-native mask*inv==1 check
_L_LO = L % (1 << _HALF)
_L_HI = L >> _HALF


def _safe_inv(x: int) -> int:
    x = int(x) % Q
    return pow(x, -1, Q) if x else 0


# ---------------------------------------------------------------------------
# generic helpers
# ---------------------------------------------------------------------------

def is_zero(api, a):
    """z = (a == 0): hint inv, constrain a*inv == 1-z and a*z == 0."""
    (inv,) = api.hint(lambda av: [[_safe_inv(x) for x in av]], [a], 1)
    z = api.sub(api.constant(1), api.mul(a, inv))
    api.mul_eq(a, z, api.constant(0))
    return z


def assert_nonzero(api, a):
    (inv,) = api.hint(lambda av: [[_safe_inv(x) for x in av]], [a], 1)
    api.mul_eq(a, inv, api.constant(1))


def assert_less_eq_const(api, a, bound: int, n_bits: int):
    """a <= bound for a known a in [0, 2^n_bits): range-decompose bound - a."""
    api.to_bits(api.sub(api.constant(bound), a), n_bits)


# ---------------------------------------------------------------------------
# BabyJubJub point gadget
# ---------------------------------------------------------------------------

def point_add(api, p1, p2):
    """Complete twisted-Edwards addition; x3, y3 hinted, denominators bound:
    x3*(1 + d*t) == x1y2 + x2y1,  y3*(1 - d*t) == y1y2 - a*x1x2."""
    x1, y1 = p1
    x2, y2 = p2
    p = api.mul(x1, y2)
    q = api.mul(x2, y1)
    u = api.mul(x1, x2)
    v = api.mul(y1, y2)
    t = api.mul(u, v)

    def hint_xy(pv, qv, uv, vv, tv):
        xs, ys = [], []
        for pp, qq, uu, vvv, tt in zip(pv, qv, uv, vv, tv):
            den_x = (1 + D * int(tt)) % Q
            den_y = (1 - D * int(tt)) % Q
            xs.append((int(pp) + int(qq)) % Q * _safe_inv(den_x) % Q)
            ys.append((int(vvv) - A * int(uu)) % Q * _safe_inv(den_y) % Q)
        return [xs, ys]

    x3, y3 = api.hint(hint_xy, [p, q, u, v, t], 2)
    one = api.constant(1)
    api.mul_eq(x3, api.add(one, api.mul_const(t, D)), api.add(p, q))
    api.mul_eq(y3, api.sub(one, api.mul_const(t, D)),
               api.sub(v, api.mul_const(u, A)))
    return (x3, y3)


def point_double(api, p):
    return point_add(api, p, p)


def assert_on_curve(api, p):
    """a*x^2 + y^2 == 1 + d*x^2*y^2 (toprf.go:116 AssertIsOnCurve)."""
    x, y = p
    x2 = api.mul(x, x)
    y2 = api.mul(y, y)
    api.mul_eq(api.mul_const(x2, D), y2,
               api.sub(api.add(api.mul_const(x2, A), y2), api.constant(1)))


def select_point(api, bit, p):
    """bit ? p : identity(0,1). One mul for x; y is affine-linear in bit*y."""
    x, y = p
    sx = api.mul(bit, x)
    sy = api.add(api.constant(1), api.sub(api.mul(bit, y), bit))
    return (sx, sy)


def scalar_mul_var(api, p, bits):
    """[sum 2^i bits_i] * p for a variable point: select + complete adds,
    addend doubled each step."""
    acc = (api.constant(0), api.constant(1))
    addend = p
    for i, b in enumerate(bits):
        acc = point_add(api, acc, select_point(api, b, addend))
        if i + 1 < len(bits):
            addend = point_double(api, addend)
    return acc


def scalar_mul_base(api, bits, base=bjj.BASE):
    """Fixed-base ladder: addends are host-precomputed 2^i multiples, so
    selection is linear (no mul wires) and only the adds cost constraints."""
    acc = (api.constant(0), api.constant(1))
    cur = base
    for b in bits:
        sx = api.mul_const(b, cur[0])
        sy = api.add(api.constant(1),
                     api.mul_const(b, (cur[1] - 1) % Q))
        acc = point_add(api, acc, (sx, sy))
        cur = bjj.add(cur, cur)
    return acc


def clear_cofactor(api, p):
    """[8]P via 3 doublings; asserts the result is not the identity
    (toprf.go:77-89)."""
    c = point_double(api, point_double(api, point_double(api, p)))
    assert_nonzero(api, c[0])
    return c


# ---------------------------------------------------------------------------
# MiMC (gnark-crypto constants — oprf/mimc.py)
# ---------------------------------------------------------------------------

def mimc_sum(api, elements):
    """In-circuit MiMC digest of field elements, h' = E_h(m) + h + m with
    x^5 rounds (3 constraints/round)."""
    h = api.constant(0)
    for m in elements:
        x = m
        for c in MIMC_CONSTANTS:
            t = api.add(x, h, api.constant(c))
            t2 = api.mul(t, t)
            t4 = api.mul(t2, t2)
            x = api.mul(t4, t)
        enc = api.add(x, h)
        h = api.add(enc, h, m)
    return h


# ---------------------------------------------------------------------------
# TOPRF pieces
# ---------------------------------------------------------------------------

def extract_secret_elements(api, bits, bitmask, length):
    """(toprf.go:38-75) Pack the masked bits into two <=31-byte little-endian
    field elements; constrain the masked-bit count == 8 * length <= 62*8."""
    assert_nonzero(api, length)
    total = len(bits)
    pow1 = api.constant(1)
    pow2 = api.constant(0)
    res1 = api.constant(0)
    res2 = api.constant(0)
    total_bits = api.constant(0)
    elem_bits = BYTES_PER_ELEMENT * 8
    for i in range(total):
        m = bitmask[i]
        bit = api.mul(m, bits[i])
        res1 = api.add(res1, api.mul(bit, pow1))
        res2 = api.add(res2, api.mul(bit, pow2))
        n = api.add(m, api.constant(1))
        pow1 = api.mul(pow1, n)
        pow2 = api.mul(pow2, n)
        total_bits = api.add(total_bits, m)
        r1_done = is_zero(api, api.sub(total_bits, api.constant(elem_bits)))
        pow1 = api.mul(pow1, api.sub(api.constant(1), r1_done))
        pow2 = api.add(pow2, r1_done)
    n_bits = max(total.bit_length() + 1, 10)
    assert_less_eq_const(api, total_bits, 2 * elem_bits, n_bits)
    api.assert_eq(total_bits, api.mul_const(length, 8))
    return res1, res2


def hash_to_point(api, s0, s1, domain_separator):
    """H = [MiMC(s0, s1, domain)]Base (toprf.go:205-221)."""
    h = mimc_sum(api, [s0, s1, domain_separator])
    return scalar_mul_base(api, api.to_bits(h, SCALAR_BITS))


def verify_dleq(api, masked, response, server_pub, c, r):
    """(toprf.go:166-203) vG = [r]Base + [c]serverPub,
    vH = [r]masked + [c]response, challenge transcript == c."""
    r_bits = api.to_bits(r, SCALAR_BITS)
    c_bits = api.to_bits(c, SCALAR_BITS)
    base = (api.constant(bjj.BASE[0]), api.constant(bjj.BASE[1]))
    vg = point_add(api, scalar_mul_base(api, r_bits),
                   scalar_mul_var(api, server_pub, c_bits))
    vh = point_add(api, scalar_mul_var(api, masked, r_bits),
                   scalar_mul_var(api, response, c_bits))
    transcript = [base[0], base[1], server_pub[0], server_pub[1],
                  vg[0], vg[1], vh[0], vh[1],
                  masked[0], masked[1], response[0], response[1]]
    api.assert_eq(mimc_sum(api, transcript), c)


_LIMB = 85                  # limb width for the non-native mask*inv==1 check
_Q_BITS = 256               # q < 2^255 (mask*inv < 2^505, L > 2^250)
_L_LIMBS = [(L >> (_LIMB * k)) & ((1 << _LIMB) - 1) for k in range(3)]
_CARRY_OFF = 1 << 100       # carries are signed, |c| < 2^95
_CARRY_BITS = 102


def _assert_mask_inverse(api, mask, mask_bits, inv, inv_bits):
    """Bind the hinted inverse: mask * inv == 1 (mod l) via the integer
    identity mask*inv - 1 == q*l, checked column-wise in 85-bit limbs with
    range-proved signed carries. Every in-field column value stays below
    ~2^173, far from wrapping mod r, and the mod-r + column checks together
    pin the exact integer identity (mask*inv, q*l < 2^505 < r * 2^252)."""
    def pack(bits, lo, hi):
        return api.from_bits(bits[lo:hi])

    def limbs3(bits, total):
        return [pack(bits, _LIMB * k, min(_LIMB * (k + 1), total))
                for k in range(3)]

    m = limbs3(mask_bits, SCALAR_BITS)
    iv = limbs3(inv_bits, SCALAR_BITS)

    def q_hint(mv, ivv):
        qs = []
        for mm, ii in zip(mv, ivv):
            prod = int(mm) * int(ii)
            assert prod % L == 1, "bad inverse hint"
            qs.append((prod - 1) // L)
        return [qs]

    (qv,) = api.hint(q_hint, [mask, inv], 1)
    q_bits = api.to_bits(qv, _Q_BITS)
    ql = limbs3(q_bits, 3 * _LIMB)
    q3 = pack(q_bits, 3 * _LIMB, _Q_BITS)
    l0, l1, l2 = _L_LIMBS

    prod = [[api.mul(m[a], iv[b]) for b in range(3)] for a in range(3)]

    def qmul(a, const):
        return api.mul_const(a, const)

    # column sums of mask*inv - 1 - q*L in base 2^85
    cols = [
        api.sub(api.sub(prod[0][0], api.constant(1)), qmul(ql[0], l0)),
        api.sub(api.add(prod[0][1], prod[1][0]),
                api.add(qmul(ql[0], l1), qmul(ql[1], l0))),
        api.sub(api.add(prod[0][2], prod[1][1], prod[2][0]),
                api.add(qmul(ql[0], l2), qmul(ql[1], l1), qmul(ql[2], l0),
                        qmul(q3, 0))),
        api.sub(api.add(prod[1][2], prod[2][1]),
                api.add(qmul(ql[1], l2), qmul(ql[2], l1), qmul(q3, l0))),
        api.sub(prod[2][2], api.add(qmul(ql[2], l2), qmul(q3, l1))),
        api.sub(api.constant(0), qmul(q3, l2)),
    ]

    carry = api.constant(0)
    for k, t in enumerate(cols):
        tk = api.add(t, carry)
        if k == len(cols) - 1:
            api.assert_eq(tk, api.constant(0))
            break

        def c_hint(tv):
            out = []
            for x in tv:
                x = int(x)
                signed = x if x <= Q // 2 else x - Q
                assert signed % (1 << _LIMB) == 0, "carry misalignment"
                out.append(signed // (1 << _LIMB) % Q)
            return [out]

        (ck,) = api.hint(c_hint, [tk], 1)
        api.assert_eq(tk, api.mul_const(ck, 1 << _LIMB))
        api.to_bits(api.add(ck, api.constant(_CARRY_OFF)), _CARRY_BITS)
        carry = ck


def unmask_point(api, response, mask, mask_bits):
    """unmasked = [mask^-1 mod l] response; the inverse is a hinted scalar
    bound by the non-native product check (reference: emulated-field
    Inverse + packScalarToVar + ScalarMul, toprf.go:127-128)."""
    def inv_hint(mv):
        return [[pow(int(m) % L, -1, L) if int(m) % L else 0 for m in mv]]

    (inv,) = api.hint(inv_hint, [mask], 1)
    inv_bits = api.to_bits(inv, SCALAR_BITS)
    _assert_mask_inverse(api, mask, mask_bits, inv, inv_bits)
    return scalar_mul_var(api, response, inv_bits)


def verify_toprf(api, params: dict, s0, s1):
    """(toprf.go:91-144) params keys: domain_separator, mask,
    responses [(x,y)]*T, coefficients [T], share_public_keys [(x,y)]*T,
    cs [T], rs [T], output."""
    assert_nonzero(api, params["mask"])
    mask_bits = api.to_bits(params["mask"], SCALAR_BITS)

    data_point = hash_to_point(api, s0, s1, params["domain_separator"])
    masked = scalar_mul_var(api, data_point, mask_bits)

    combined = (api.constant(0), api.constant(1))
    for i in range(THRESHOLD):
        resp = params["responses"][i]
        pub = params["share_public_keys"][i]
        assert_on_curve(api, resp)
        assert_on_curve(api, pub)
        cleared_resp = clear_cofactor(api, resp)
        cleared_pub = clear_cofactor(api, pub)
        verify_dleq(api, masked, cleared_resp, cleared_pub,
                    params["cs"][i], params["rs"][i])
        coeff_bits = api.to_bits(params["coefficients"][i], SCALAR_BITS)
        combined = point_add(api, combined,
                             scalar_mul_var(api, resp, coeff_bits))

    unmasked = unmask_point(api, combined, params["mask"], mask_bits)
    out = mimc_sum(api, [unmasked[0], unmasked[1], s0, s1])
    api.assert_eq(out, params["output"])


# ---------------------------------------------------------------------------
# layouts + witness helpers for the *-toprf circuit variants
# ---------------------------------------------------------------------------

TOPRF_PUBLIC_LAYOUT = [
    ("toprf_domain", 1), ("toprf_resp", 2 * THRESHOLD),
    ("toprf_coeff", THRESHOLD), ("toprf_share_pub", 2 * THRESHOLD),
    ("toprf_c", THRESHOLD), ("toprf_r", THRESHOLD), ("toprf_out", 1),
]
TOPRF_PRIVATE_LAYOUT = [("toprf_mask", 1)]


def params_from_vars(v: dict) -> dict:
    return {
        "domain_separator": v["toprf_domain"][0],
        "mask": v["toprf_mask"][0],
        "responses": [(v["toprf_resp"][2 * i], v["toprf_resp"][2 * i + 1])
                      for i in range(THRESHOLD)],
        "coefficients": list(v["toprf_coeff"]),
        "share_public_keys": [(v["toprf_share_pub"][2 * i],
                               v["toprf_share_pub"][2 * i + 1])
                              for i in range(THRESHOLD)],
        "cs": list(v["toprf_c"]),
        "rs": list(v["toprf_r"]),
        "output": v["toprf_out"][0],
    }


def toprf_witness_values(domain_separator: bytes, request, responses: dict,
                         indices: list, output: int, batch: int = 1):
    """Host values for the TOPRF public/private inputs of one proof,
    replicated over the batch axis. responses: {index: OPRFResponse}."""
    from ...oprf.oprf import lagrange_coeff
    assert len(indices) == THRESHOLD
    rep = lambda x: [int(x)] * batch
    pub = {
        "toprf_domain": [rep(int.from_bytes(domain_separator, "big"))],
        "toprf_resp": [], "toprf_coeff": [], "toprf_share_pub": [],
        "toprf_c": [], "toprf_r": [],
        "toprf_out": [rep(output)],
    }
    for i in indices:
        r = responses[i]
        pub["toprf_resp"] += [rep(r.evaluated[0]), rep(r.evaluated[1])]
        pub["toprf_share_pub"] += [rep(r.public_key[0]), rep(r.public_key[1])]
        pub["toprf_coeff"].append(rep(lagrange_coeff(indices, i)))
        pub["toprf_c"].append(rep(r.dleq.c))
        pub["toprf_r"].append(rep(r.dleq.r))
    priv = {"toprf_mask": [rep(request.mask)]}
    return pub, priv

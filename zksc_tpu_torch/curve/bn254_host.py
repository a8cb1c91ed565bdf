"""Host-side BN254 (alt_bn128) arithmetic: tower fields, G1/G2, optimal ate pairing.

This is the verifier-side and setup-side reference implementation in pure
Python ints. It fills the role of gnark's `groth16.Verify` pairing check
(reference behavior: gnark/libraries/verifier/impl/library.go:162-182) —
pairings are small and latency-insensitive, so they stay on host; the prover
hot loops (MSM/NTT) run on the GPU (see zksc_tpu_torch.ops).

Curve: y^2 = x^3 + 3 over Fp; G2 on the sextic D-twist y^2 = x^3 + 3/(9+i)
over Fp2 = Fp[i]/(i^2+1). Tower: Fp6 = Fp2[v]/(v^3 - xi), xi = 9 + i;
Fp12 = Fp6[w]/(w^2 - v). Untwist maps E'(Fp2) -> E(Fp12) via
(x, y) -> (x*w^2, y*w^3) (w^6 = xi).
"""
from __future__ import annotations

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
BN_U = 4965661367192848881                 # BN parameter t
ATE_LOOP_COUNT = 6 * BN_U + 2              # 29793968203157093288


# ---------------------------------------------------------------------------
# Tower fields (immutable tuples + free functions; fast enough for verify)
# ---------------------------------------------------------------------------

def f2_add(a, b): return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)
def f2_sub(a, b): return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)
def f2_neg(a): return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    # (a0 + a1 i)(b0 + b1 i), i^2 = -1 — Karatsuba
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    t2 = (a[0] + a[1]) * (b[0] + b[1]) % P
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def f2_sqr(a): return f2_mul(a, a)
def f2_scalar(a, k): return (a[0] * k % P, a[1] * k % P)


def f2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], -1, P)
    return (a[0] * d % P, (-a[1]) * d % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)                                 # xi = 9 + i


def f2_mul_xi(a):
    """a * (9 + i)."""
    return ((9 * a[0] - a[1]) % P, (a[0] + 9 * a[1]) % P)


def f6_add(a, b): return tuple(f2_add(x, y) for x, y in zip(a, b))
def f6_sub(a, b): return tuple(f2_sub(x, y) for x, y in zip(a, b))
def f6_neg(a): return tuple(f2_neg(x) for x in a)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_mul_by_v(a):
    """a * v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    t0 = f2_sub(f2_sqr(a0), f2_mul_xi(f2_mul(a1, a2)))
    t1 = f2_sub(f2_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    t2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    den = f2_add(f2_mul(a0, t0), f2_mul_xi(f2_add(f2_mul(a2, t1), f2_mul(a1, t2))))
    di = f2_inv(den)
    return (f2_mul(t0, di), f2_mul(t1, di), f2_mul(t2, di))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f12_add(a, b): return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))
def f12_sub(a, b): return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))
def f12_neg(a): return (f6_neg(a[0]), f6_neg(a[1]))


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_by_v(t1))
    c1 = f6_sub(f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), t0), t1)
    return (c0, c1)


def f12_sqr(a): return f12_mul(a, a)


def f12_inv(a):
    a0, a1 = a
    den = f6_sub(f6_mul(a0, a0), f6_mul_by_v(f6_mul(a1, a1)))
    di = f6_inv(den)
    return (f6_mul(a0, di), f6_neg(f6_mul(a1, di)))


def f12_conj(a):
    """Conjugation a0 - a1 w = a^(p^6)."""
    return (a[0], f6_neg(a[1]))


def f12_pow(a, e: int):
    result = F12_ONE
    for bit in bin(e)[2:]:
        result = f12_sqr(result)
        if bit == "1":
            result = f12_mul(result, a)
    return result


F12_ZERO = (F6_ZERO, F6_ZERO)
F12_ONE = (F6_ONE, F6_ZERO)


def f12_eq(a, b): return a == b


def f12_from_f2(x):
    return ((x, F2_ZERO, F2_ZERO), F6_ZERO)


def f12_from_int(x):
    return (((x % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


# Frobenius on Fp12 via precomputed gamma constants:
# (a0 + a1 w)^p; on Fp2 coefficients c -> conj(c) * gamma.
def _f2_conj(a): return (a[0], (-a[1]) % P)


def _f2_pow(a, e):
    r = F2_ONE
    for bit in bin(e)[2:]:
        r = f2_sqr(r)
        if bit == "1":
            r = f2_mul(r, a)
    return r


# gamma_1,j = xi^(j*(p-1)/6) for j = 1..5
_G1J = [_f2_pow(XI, j * (P - 1) // 6) for j in range(6)]


def f12_frobenius(a):
    """a^p. Basis 1, v, v^2, w, vw, v^2 w: coefficient j of w^?*v^? picks up
    gamma_1,(power of w in w^k) where element basis exponents k = 0..5 map:
    c_{i,j} sits on w^(2j + ... ) — we use: Fp12 elt = sum over k in 0..5 of
    c_k * W^k with W = w, and W^6 = xi; coefficient c_k in Fp2.
    Convert tower -> flat, apply conj * gamma_1^k, convert back."""
    (a0, a1) = a
    flat = [a0[0], a1[0], a0[1], a1[1], a0[2], a1[2]]   # W^0..W^5: w^2 = v
    out = []
    for k, c in enumerate(flat):
        out.append(f2_mul(_f2_conj(c), _G1J[k]))
    return ((out[0], out[2], out[4]), (out[1], out[3], out[5]))


# ---------------------------------------------------------------------------
# G1 (affine over Fp) and G2 (affine over Fp2)
# ---------------------------------------------------------------------------

B1 = 3
# b2 = 3 / (9 + i)
B2 = f2_scalar(f2_inv(XI), 3)

G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)

# Points are affine tuples; None is the point at infinity.


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B1) % P == 0


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return f2_sub(f2_sqr(y), f2_add(f2_mul(x, f2_sqr(x)), B2)) == F2_ZERO


def _ec_add(p1, p2, add, sub, mul, sqr, inv, neg):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 != y2:
        return None
    if x1 == x2:  # doubling (no order-2 points in the prime-order subgroups)
        m = mul(scalar3(sqr(x1)), inv(add(y1, y1)))
    else:
        m = mul(sub(y2, y1), inv(sub(x2, x1)))
    x3 = sub(sub(sqr(m), x1), x2)
    y3 = sub(mul(m, sub(x1, x3)), y1)
    return (x3, y3)


def scalar3(v):
    if isinstance(v, int):
        return 3 * v % P
    return f2_scalar(v, 3)


def g1_add(p1, p2):
    return _ec_add(p1, p2,
                   lambda a, b: (a + b) % P, lambda a, b: (a - b) % P,
                   lambda a, b: a * b % P, lambda a: a * a % P,
                   lambda a: pow(a, -1, P), lambda a: (-a) % P)


def g2_add(p1, p2):
    return _ec_add(p1, p2, f2_add, f2_sub, f2_mul, f2_sqr, f2_inv, f2_neg)


def g1_neg(p):
    return None if p is None else (p[0], (-p[1]) % P)


def g2_neg(p):
    return None if p is None else (p[0], f2_neg(p[1]))


def _ec_mul(p, k: int, add_fn, neg_fn):
    if k % R == 0 or p is None:
        return None
    k = k % R
    result = None
    addend = p
    while k:
        if k & 1:
            result = add_fn(result, addend)
        addend = add_fn(addend, addend)
        k >>= 1
    return result


def g1_mul(p, k: int):
    return _ec_mul(p, k, g1_add, g1_neg)


def g2_mul(p, k: int):
    return _ec_mul(p, k, g2_add, g2_neg)


def g1_is_canonical(pt) -> bool:
    """Coordinates reduced mod p (rejects malleable non-canonical encodings)."""
    if pt is None:
        return True
    x, y = pt
    return 0 <= x < P and 0 <= y < P


def g2_is_canonical(pt) -> bool:
    if pt is None:
        return True
    (x0, x1), (y0, y1) = pt
    return all(0 <= c < P for c in (x0, x1, y0, y1))


def g2_in_subgroup(pt) -> bool:
    """Order-R subgroup membership on the twist. BN254's E'(Fp2) has a large
    cofactor, so on-curve does NOT imply subgroup membership; reference
    verifiers get this via strict deserialization (gnark
    libraries/verifier/impl — groth16.Verify path). Plain mul-by-R ladder
    (NOT _ec_mul, which reduces k mod R and would trivially return None)."""
    if pt is None:
        return True
    if not g2_is_on_curve(pt):
        return False
    try:
        result, addend, k = None, pt, R
        while k:
            if k & 1:
                result = g2_add(result, addend)
            if addend is not None and addend[1] == F2_ZERO:
                addend = None  # order-2 point: doubling hits infinity
            else:
                addend = g2_add(addend, addend)
            k >>= 1
        return result is None
    except (ValueError, ZeroDivisionError):
        return False  # degenerate arithmetic (e.g. inverting zero)


# ---------------------------------------------------------------------------
# Optimal ate pairing
# ---------------------------------------------------------------------------

def _untwist(pt):
    """E'(Fp2) -> E(Fp12): (x, y) -> (x w^2, y w^3); w^2 = v, w^3 = v*w."""
    if pt is None:
        return None
    x, y = pt
    nx = ((F2_ZERO, x, F2_ZERO), F6_ZERO)          # x * v
    ny = (F6_ZERO, (F2_ZERO, y, F2_ZERO))          # y * v * w
    return (nx, ny)


def _f12_pt_eq(p1, p2):
    return p1 == p2


def _line(p1, p2, t):
    """Line through p1,p2 (E(Fp12) affine), evaluated at t. py_ecc-style."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    elif y1 == y2:
        m = f12_mul(f12_mul(f12_sqr(x1), f12_from_int(3)),
                    f12_inv(f12_add(y1, y1)))
    else:
        return f12_sub(xt, x1)
    return f12_sub(f12_mul(m, f12_sub(xt, x1)), f12_sub(yt, y1))


def _f12_pt_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 != y2:
        return None
    if x1 == x2:
        m = f12_mul(f12_mul(f12_sqr(x1), f12_from_int(3)), f12_inv(f12_add(y1, y1)))
    else:
        m = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    x3 = f12_sub(f12_sub(f12_sqr(m), x1), x2)
    y3 = f12_sub(f12_mul(m, f12_sub(x1, x3)), y1)
    return (x3, y3)


def miller_loop(q_tw, p_emb):
    """q_tw: untwisted G2 point on E(Fp12); p_emb: embedded G1 point."""
    if q_tw is None or p_emb is None:
        return F12_ONE
    rpt = q_tw
    f = F12_ONE
    for bit in bin(ATE_LOOP_COUNT)[3:]:
        f = f12_mul(f12_sqr(f), _line(rpt, rpt, p_emb))
        rpt = _f12_pt_add(rpt, rpt)
        if bit == "1":
            f = f12_mul(f, _line(rpt, q_tw, p_emb))
            rpt = _f12_pt_add(rpt, q_tw)
    q1 = (f12_frobenius(q_tw[0]), f12_frobenius(q_tw[1]))
    nq2 = (f12_frobenius(q1[0]), f12_neg(f12_frobenius(q1[1])))
    f = f12_mul(f, _line(rpt, q1, p_emb))
    rpt = _f12_pt_add(rpt, q1)
    f = f12_mul(f, _line(rpt, nq2, p_emb))
    return f


def final_exponentiation(f):
    """f^((p^12-1)/r): easy part via conjugation/frobenius, hard part direct."""
    # easy: f^(p^6-1) = conj(f) * f^-1 ; then ^(p^2+1)
    f = f12_mul(f12_conj(f), f12_inv(f))
    f = f12_mul(f12_frobenius(f12_frobenius(f)), f)
    # hard: ^((p^4 - p^2 + 1) / r)
    hard = (P ** 4 - P ** 2 + 1) // R
    return f12_pow(f, hard)


def pairing(p1, q2) -> tuple:
    """e(P in G1, Q in G2) in Fp12 (full reduced pairing)."""
    if p1 is None or q2 is None:
        return F12_ONE
    assert g1_is_on_curve(p1) and g2_is_on_curve(q2)
    p_emb = (f12_from_int(p1[0]), f12_from_int(p1[1]))
    return final_exponentiation(miller_loop(_untwist(q2), p_emb))


def multi_pairing(pairs) -> tuple:
    """prod e(Pi, Qi): shares one final exponentiation."""
    f = F12_ONE
    for (p1, q2) in pairs:
        if p1 is None or q2 is None:
            continue
        p_emb = (f12_from_int(p1[0]), f12_from_int(p1[1]))
        f = f12_mul(f, miller_loop(_untwist(q2), p_emb))
    return final_exponentiation(f)


# import-time sanity: generators on curve
assert g1_is_on_curve(G1_GEN)
assert g2_is_on_curve(G2_GEN), "G2 generator constants wrong"


# ---- host Jacobian arithmetic (no per-op field inversions) ----
# Used for the MSM window combine: ~250 sequential doublings are ~10x
# faster in python-int Jacobian coordinates than with the affine add above
# (which pays a modular inverse per operation).

def _jach_ops(g2: bool):
    if g2:
        return f2_add, f2_sub, f2_mul, f2_sqr, f2_neg, F2_ONE
    return ((lambda a, b: (a + b) % P), (lambda a, b: (a - b) % P),
            (lambda a, b: a * b % P), (lambda a: a * a % P),
            (lambda a: (-a) % P), 1)


def jac_double_host(pt, g2: bool = False):
    """Jacobian double; pt = (X, Y, Z) or None (identity). a = 0 curve."""
    if pt is None:
        return None
    add, sub, mul, sqr, neg, one = _jach_ops(g2)
    X, Y, Z = pt
    A = sqr(X)
    B = sqr(Y)
    C = sqr(B)
    D = sub(sqr(add(X, B)), add(A, C))
    D = add(D, D)
    E = add(add(A, A), A)
    F = sqr(E)
    X3 = sub(F, add(D, D))
    Y3 = sub(mul(E, sub(D, X3)), add(add(add(C, C), add(C, C)),
                                     add(add(C, C), add(C, C))))
    Z3 = mul(add(Y, Y), Z)
    return (X3, Y3, Z3)


def jac_add_host(p1, p2, g2: bool = False):
    """Jacobian complete add (handles identity and doubling)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    add, sub, mul, sqr, neg, one = _jach_ops(g2)
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1 = sqr(Z1)
    Z2Z2 = sqr(Z2)
    U1 = mul(X1, Z2Z2)
    U2 = mul(X2, Z1Z1)
    S1 = mul(mul(Y1, Z2), Z2Z2)
    S2 = mul(mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 == S2:
            return jac_double_host(p1, g2)
        return None
    H = sub(U2, U1)
    I = sqr(add(H, H))
    J = mul(H, I)
    r = add(sub(S2, S1), sub(S2, S1))
    V = mul(U1, I)
    X3 = sub(sub(sqr(r), J), add(V, V))
    Y3 = sub(mul(r, sub(V, X3)), add(mul(S1, J), mul(S1, J)))
    Z3 = mul(sub(sqr(add(Z1, Z2)), add(Z1Z1, Z2Z2)), H)
    return (X3, Y3, Z3)


def jac_from_affine_host(pt, g2: bool = False):
    if pt is None:
        return None
    _, _, _, _, _, one = _jach_ops(g2)
    return (pt[0], pt[1], one)


def jac_to_affine_host(pt, g2: bool = False):
    if pt is None:
        return None
    X, Y, Z = pt
    if g2:
        if Z == (0, 0):
            return None
        zi = f2_inv(Z)
        zi2 = f2_sqr(zi)
        return (f2_mul(X, zi2), f2_mul(Y, f2_mul(zi2, zi)))
    if Z == 0:
        return None
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 % P * zi % P)


def combine_windows_host(window_points: list, c: int, g2: bool = False):
    """sum_w 2^(c*w) * S_w for host affine window sums [S_0..S_{W-1}]
    (None = identity): Horner from the top window in Jacobian coords.
    Returns host affine (or None)."""
    acc = None
    for S in reversed(window_points):
        if acc is not None:
            for _ in range(c):
                acc = jac_double_host(acc, g2)
        S_j = jac_from_affine_host(S, g2)
        acc = jac_add_host(acc, S_j, g2) if acc is not None else S_j
    return jac_to_affine_host(acc, g2)


def jac_mul_host(pt_affine, k: int, g2: bool = False):
    """k * P in host Jacobian coords (MSB-first double-and-add); pt_affine
    host affine or None. Returns Jacobian (or None)."""
    if pt_affine is None or k % R == 0:
        return None
    k %= R
    P_j = jac_from_affine_host(pt_affine, g2)
    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = jac_double_host(acc, g2)
        if bit == "1":
            acc = jac_add_host(acc, P_j, g2) if acc is not None else P_j
    return acc

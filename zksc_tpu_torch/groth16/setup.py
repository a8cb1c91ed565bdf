"""Groth16 trusted setup (keygen) for BN254, and the key types.

The JAX package's ``groth16/setup.py``: compile a circuit to R1CS, sample
toxic waste, produce proving/verifying keys, pin the circuit digest.

Scalar-side evaluations (QAP polynomials at tau in the Lagrange basis) run
on the host with Python ints; the heavy part, one fixed-base scalar
multiplication per wire per query, runs on the device through windowed
fixed-base tables (ops.msm.batch_scalar_mul_fixed_base: host-precomputed
window multiples, then one gather + one K2 add per 8-bit window). H-query
points are stored in BIT-REVERSED order so the prover feeds NTT output
straight into the MSM. With the same ``rng`` the keys equal the JAX
package's point for point.
"""
from __future__ import annotations

import secrets
import time
from dataclasses import dataclass

from ..curve import bn254_host as host
from ..device import resolve_device
from ..fields.limb import Fp, Fr
from ..ops import ec, msm
from ..ops.ntt import bit_reverse_perm, find_2adic_root
from ..r1cs.builder import ConstraintSystem


@dataclass
class ProvingKey:
    """Device-resident query tables (JacPoint batches) + metadata."""
    n_public: int
    n_wires: int
    domain_n: int
    a_query: object          # JacPoint [n_wires]  (G1)
    b_g1_query: object       # JacPoint [n_wires]  (G1)
    b_g2_query: object       # JacPoint [n_wires]  (G2, folded [L, 2N])
    c_query: object          # JacPoint [n_wires - n_public - 1] (G1, private wires)
    h_query: object          # JacPoint [domain_n] (G1, bit-reversed tau-power basis)
    delta_g1: tuple
    beta_g1: tuple
    alpha_g1: tuple
    beta_g2: tuple = None
    delta_g2: tuple = None
    digest: str = ""


@dataclass
class VerifyingKey:
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    ic: list                 # [n_public + 1] G1 points
    digest: str = ""


def setup(cs: ConstraintSystem, rng=None, device=None, timings=None) -> tuple:
    """Run the trusted setup on `device` (default "cuda"). Returns
    (ProvingKey, VerifyingKey) with the key's tables on that device.

    rng: optional callable () -> int for deterministic testing, drawn in the
    order tau, alpha, beta, gamma, delta; defaults to a cryptographically
    secure source. timings: optional dict that receives the seconds of
    each stage: host QAP evaluation, the fixed-base products' window tables
    (host), combine (device) and affine conversion (host), and the keys'
    transfer back to the device."""
    dev = resolve_device(device)
    t = [time.perf_counter()]
    r = host.R
    if rng is None:
        rng = lambda: secrets.randbelow(r - 1) + 1
    tau, alpha, beta, gamma, delta = rng(), rng(), rng(), rng(), rng()

    n_con = cs.n_constraints
    domain_n = max(4, 1 << (n_con - 1).bit_length() if n_con > 1 else 2)
    w = find_2adic_root(Fr, domain_n)

    # Lagrange basis at tau: L_k(tau) = w^k (tau^n - 1) / (n (tau - w^k))
    z_tau = (pow(tau, domain_n, r) - 1) % r
    assert z_tau != 0, "tau hit the domain (probability ~2^-226)"
    n_inv = pow(domain_n, -1, r)
    denoms = []
    wk = 1
    for k in range(n_con):
        denoms.append((tau - wk) % r)
        wk = wk * w % r
    inv_denoms = _batch_inverse(denoms, r)
    lag = []
    wk = 1
    for k in range(n_con):
        lag.append(z_tau * n_inv % r * wk % r * inv_denoms[k] % r)
        wk = wk * w % r

    # QAP polynomial evaluations per wire
    m = cs.n_wires
    A = [0] * m
    B = [0] * m
    C = [0] * m
    for k, (la, lb, lc) in enumerate(cs.constraints):
        lk = lag[k]
        for wire, coeff in la.items():
            A[wire] = (A[wire] + coeff * lk) % r
        for wire, coeff in lb.items():
            B[wire] = (B[wire] + coeff * lk) % r
        for wire, coeff in lc.items():
            C[wire] = (C[wire] + coeff * lk) % r

    gamma_inv = pow(gamma, -1, r)
    delta_inv = pow(delta, -1, r)
    n_pub = cs.n_public
    ell = n_pub + 1               # wires 0..n_pub are public (incl. constant 1)

    k_terms = [(beta * A[i] + alpha * B[i] + C[i]) % r for i in range(m)]
    ic_scalars = [k_terms[i] * gamma_inv % r for i in range(ell)]
    c_scalars = [k_terms[i] * delta_inv % r for i in range(ell, m)]

    # H query scalars: tau^k * Z(tau) / delta, k < n-1 (padded to n), bit-reversed
    h_scalars_nat = []
    tk = z_tau * delta_inv % r
    for k in range(domain_n):
        h_scalars_nat.append(tk if k < domain_n - 1 else 0)
        tk = tk * tau % r
    br = bit_reverse_perm(domain_n)
    h_scalars = [h_scalars_nat[int(br[i])] for i in range(domain_n)]
    t.append(time.perf_counter())

    # ---- group elements (fixed-base products on the device) ----
    g1, g2 = host.G1_GEN, host.G2_GEN
    fb_times: dict = {}
    fb = lambda sc, base, is_g2: msm.batch_scalar_mul_fixed_base(
        sc, base, g2=is_g2, device=dev, timings=fb_times)
    a_pts = fb(A, g1, False)
    b1_pts = fb(B, g1, False)
    b2_pts = fb(B, g2, True)
    c_pts = fb(c_scalars, g1, False)
    h_pts = fb(h_scalars, g1, False)
    ic_pts = fb(ic_scalars, g1, False)
    t.append(time.perf_counter())

    alpha_g1 = host.g1_mul(g1, alpha)
    beta_g1 = host.g1_mul(g1, beta)
    delta_g1 = host.g1_mul(g1, delta)
    beta_g2 = host.g2_mul(g2, beta)
    gamma_g2 = host.g2_mul(g2, gamma)
    delta_g2 = host.g2_mul(g2, delta)

    digest = cs.digest()
    pk = ProvingKey(
        n_public=n_pub, n_wires=m, domain_n=domain_n,
        a_query=_pad_dev_g1(a_pts, dev),
        b_g1_query=_pad_dev_g1(b1_pts, dev),
        b_g2_query=_pad_dev_g2(b2_pts, dev),
        c_query=_pad_dev_g1(c_pts, dev),
        h_query=_pad_dev_g1(h_pts, dev),
        delta_g1=delta_g1, beta_g1=beta_g1, alpha_g1=alpha_g1,
        beta_g2=beta_g2, delta_g2=delta_g2,
        digest=digest,
    )
    vk = VerifyingKey(alpha_g1=alpha_g1, beta_g2=beta_g2, gamma_g2=gamma_g2,
                      delta_g2=delta_g2, ic=ic_pts, digest=digest)
    t.append(time.perf_counter())
    if timings is not None:
        timings.update(qap_host_s=t[1] - t[0], **fb_times,
                       key_to_device_s=t[3] - t[2])
    return pk, vk


def _pad_dev_g1(pts: list, device):
    npad = max(1, 1 << (len(pts) - 1).bit_length())
    return ec.g1_points_to_device(Fp, pts + [None] * (npad - len(pts)),
                                  device=device)


def _pad_dev_g2(pts: list, device):
    npad = max(1, 1 << (len(pts) - 1).bit_length())
    return ec.g2_points_to_device(Fp, pts + [None] * (npad - len(pts)),
                                  device=device)


def _batch_inverse(xs: list, p: int) -> list:
    """Montgomery's batch-inversion trick: one modular inverse for n elements."""
    n = len(xs)
    if n == 0:
        return []
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % p
    inv_all = pow(prefix[n], -1, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % p
        inv_all = inv_all * xs[i] % p
    return out

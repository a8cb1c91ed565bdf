"""Groth16 key types for BN254.

The JAX package's ``groth16/setup.py`` also runs the trusted setup
(``setup()``, fixed-base MSMs on the device); that is not ported yet, so
this port proves with keys made by the reference and loaded through
``groth16/artifacts.py`` (committed ``artifacts/*/pk.npz``, or a key that the
JAX package made in memory, converted with ``proving_key_from_numpy``).
"""
from __future__ import annotations

from dataclasses import dataclass


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

"""Threshold OPRF over BabyJubJub (host Python ints): the curve, MiMC, the
protocol with DLEQ proofs and Shamir shares, the bitmask of redacted
spans, and the share operator's wire format. Copied from the JAX package's
host-only ``oprf/`` so that the port imports nothing of it."""
from . import babyjubjub, mimc, oprf

__all__ = ["babyjubjub", "mimc", "oprf"]

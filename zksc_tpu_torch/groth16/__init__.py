from .prove import Proof, ProverContext
from .setup import ProvingKey, VerifyingKey, setup
from .verify import verify

__all__ = ["Proof", "ProverContext", "ProvingKey", "VerifyingKey", "setup",
           "verify"]

"""Device choice for the port's entry points.

The entry points (api.generate_proof(s), api.verify_proof,
operators.Groth16Operator, groth16.ProverContext) run on the GPU unless the
caller asks for the CPU: ``device=None`` means "cuda", and asking for CUDA
where none is present raises instead of silently running elsewhere.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

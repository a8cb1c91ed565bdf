"""Proving/verifying key (de)serialization for the local artifact store.

A key directory holds ``pk.npz`` (uint32 limb arrays, G2 folded),
``pk_meta.json`` and ``vk.json`` with the circuit digest pinned, in the
JAX package's format: ``save_keys`` writes what its ``load_keys`` reads and
the other way round. Loading checks the digest against the freshly compiled
circuit before use. ``proving_key_from_numpy`` converts numpy limb arrays
(``pk.npz``, or a key of the JAX package in memory) to this port's
ProvingKey.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops.ec import JacPoint
from .setup import ProvingKey, VerifyingKey

ARTIFACT_VERSION = 1

_QUERIES = (("a", "a_query", False), ("b1", "b_g1_query", False),
            ("b2", "b_g2_query", True), ("c", "c_query", False),
            ("h", "h_query", False))


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.size and int(a.max()) >= 1 << 16:
        raise ValueError("limb array holds values >= 2^16")
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.int32))).to(device)


def _jac_from_np(d, prefix: str, g2: bool, device) -> JacPoint:
    if g2 and (prefix + "x0") in d:
        # legacy v1 format: per-component arrays -> fold into [L, 2N]
        fold = lambda c0, c1: _tensor(np.concatenate(
            [np.asarray(d[prefix + c0]), np.asarray(d[prefix + c1])],
            axis=-1), device)
        return JacPoint(fold("x0", "x1"), fold("y0", "y1"), fold("z0", "z1"))
    return JacPoint(*(_tensor(d[prefix + k], device) for k in "xyz"))


def _pt_json(p):
    return None if p is None else [str(p[0]), str(p[1])]


def _pt2_json(p):
    if p is None:
        return None
    return [[str(p[0][0]), str(p[0][1])], [str(p[1][0]), str(p[1][1])]]


def _pt_from_json(j):
    return None if j is None else (int(j[0]), int(j[1]))


def _pt2_from_json(j):
    if j is None:
        return None
    return ((int(j[0][0]), int(j[0][1])), (int(j[1][0]), int(j[1][1])))


def proving_key_from_numpy(arrays: dict, meta: dict, device) -> ProvingKey:
    """The JAX package's proving key -> this port's ProvingKey on `device`.

    arrays: ``{"a_x": ..., "a_y": ..., ..., "h_z": ...}`` numpy limb arrays
    ([16, N] uint32; G2 folded [16, 2N], or the legacy ``b2_x0 .. b2_z1``
    component halves of ``pk.npz``), as ``np.asarray`` of each JacPoint
    coordinate or the arrays of ``pk.npz``. meta: n_public, n_wires,
    domain_n, alpha_g1, beta_g1, delta_g1, beta_g2, delta_g2 (int tuples or
    the decimal strings of ``pk_meta.json``) and optionally digest."""
    queries = {attr: _jac_from_np(arrays, name + "_", g2, device)
               for name, attr, g2 in _QUERIES}
    return ProvingKey(
        n_public=int(meta["n_public"]), n_wires=int(meta["n_wires"]),
        domain_n=int(meta["domain_n"]),
        alpha_g1=_pt_from_json(meta["alpha_g1"]),
        beta_g1=_pt_from_json(meta["beta_g1"]),
        delta_g1=_pt_from_json(meta["delta_g1"]),
        beta_g2=_pt2_from_json(meta["beta_g2"]),
        delta_g2=_pt2_from_json(meta["delta_g2"]),
        digest=meta.get("digest", ""),
        **queries,
    )


def save_keys(dirpath: str, pk: ProvingKey, vk: VerifyingKey):
    """Write pk.npz, pk_meta.json and vk.json into `dirpath`."""
    os.makedirs(dirpath, exist_ok=True)
    arrays = {}
    for name, attr, _ in _QUERIES:
        for k, a in zip("xyz", getattr(pk, attr)):
            arrays[f"{name}_{k}"] = a.cpu().numpy().astype(np.uint32)
    np.savez_compressed(os.path.join(dirpath, "pk.npz"), **arrays)
    meta = {
        "version": ARTIFACT_VERSION,
        "digest": pk.digest,
        "n_public": pk.n_public,
        "n_wires": pk.n_wires,
        "domain_n": pk.domain_n,
        "alpha_g1": _pt_json(pk.alpha_g1),
        "beta_g1": _pt_json(pk.beta_g1),
        "delta_g1": _pt_json(pk.delta_g1),
        "beta_g2": _pt2_json(pk.beta_g2),
        "delta_g2": _pt2_json(pk.delta_g2),
    }
    with open(os.path.join(dirpath, "pk_meta.json"), "w") as f:
        json.dump(meta, f)
    vk_json = {
        "version": ARTIFACT_VERSION,
        "digest": vk.digest,
        "protocol": "groth16",
        "curve": "bn128",
        "vk_alpha_1": _pt_json(vk.alpha_g1),
        "vk_beta_2": _pt2_json(vk.beta_g2),
        "vk_gamma_2": _pt2_json(vk.gamma_g2),
        "vk_delta_2": _pt2_json(vk.delta_g2),
        "IC": [_pt_json(p) for p in vk.ic],
    }
    with open(os.path.join(dirpath, "vk.json"), "w") as f:
        json.dump(vk_json, f)


def load_keys(dirpath: str, expected_digest: str | None = None, device=None):
    """Returns (pk, vk) with pk's tables on `device`; verifies the pinned
    digest if provided (mirrors the reference's pk/r1cs hash check)."""
    with open(os.path.join(dirpath, "pk_meta.json")) as f:
        meta = json.load(f)
    if expected_digest is not None and meta["digest"] != expected_digest:
        raise ValueError(
            f"artifact digest mismatch: {meta['digest']} != {expected_digest}")
    with np.load(os.path.join(dirpath, "pk.npz")) as data:
        pk = proving_key_from_numpy(data, meta, device)
    vk = load_vk(dirpath, expected_digest)
    return pk, vk


def load_vk(dirpath: str, expected_digest: str | None = None) -> VerifyingKey:
    with open(os.path.join(dirpath, "vk.json")) as f:
        vj = json.load(f)
    if expected_digest is not None and vj["digest"] != expected_digest:
        raise ValueError("vk digest mismatch")
    return VerifyingKey(
        alpha_g1=_pt_from_json(vj["vk_alpha_1"]),
        beta_g2=_pt2_from_json(vj["vk_beta_2"]),
        gamma_g2=_pt2_from_json(vj["vk_gamma_2"]),
        delta_g2=_pt2_from_json(vj["vk_delta_2"]),
        ic=[_pt_from_json(p) for p in vj["IC"]],
        digest=vj["digest"],
    )

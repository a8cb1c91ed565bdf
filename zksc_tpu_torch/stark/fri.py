"""FRI low-degree test over the M31 circle domain (Circle-STARK engine).

A copy of the JAX package's ``stark/fri.py`` (numpy on the host), whose
Merkle commitments take the device: on the card a tree of at least
``merkle.DEVICE_MIN_LEAVES`` leaves is hashed by K7a.

Commit phase folds QM31 evaluations with channel-drawn alphas — one y-fold,
then x-folds through the doubling map, mirroring the circle-FFT layer
structure (stark.circle) — until the honest polynomial is CONSTANT on the
residual domain (rate 1/2^log_blowup). Each layer is Merkle-committed
(stark.merkle); queries open fold-pair values with auth paths; grinding via
the channel PoW. Fills the role of stwo's FRI commit/fold + queries + PoW
(SURVEY.md §2.5 item 4); transcript format is our own, documented.

Degree bound: a polynomial whose coefficients (in the circle-FFT basis) are
supported on indices < N / 2^log_blowup folds to a constant, so the verifier
accepts; anything of higher degree fails w.h.p.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..device import resolve_device
from .channel import Channel
from .circle import CircleFFT
from .m31 import P31
from . import merkle

INV2 = pow(2, -1, P31)


# ---- host QM31 helpers (verifier + fold math on small query sets) ----

def _qm_add(a, b):
    return tuple((x + y) % P31 for x, y in zip(a, b))


def _qm_sub(a, b):
    return tuple((x - y) % P31 for x, y in zip(a, b))


def _qm_scale(a, s):
    return tuple(x * s % P31 for x in a)


def _qm_mul(a, b):
    # (a0 + a1 i + (a2 + a3 i) u), i^2 = -1, u^2 = 2 + i
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    c0 = (a0 * b0 - a1 * b1) % P31
    c1 = (a0 * b1 + a1 * b0) % P31
    d0 = (a2 * b2 - a3 * b3) % P31
    d1 = (a2 * b3 + a3 * b2) % P31
    # (d0 + d1 i) * (2 + i) = 2 d0 - d1 + (d0 + 2 d1) i
    e0 = (2 * d0 - d1) % P31
    e1 = (d0 + 2 * d1) % P31
    x0 = (c0 + e0) % P31
    x1 = (c1 + e1) % P31
    y0 = (a0 * b2 - a1 * b3 + a2 * b0 - a3 * b1) % P31
    y1 = (a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0) % P31
    return (x0, x1, y0, y1)


def _leaf_bytes(v) -> bytes:
    return b"".join(int(x).to_bytes(4, "little") for x in v)


def _qm_mul_scalar_np(alpha, d: np.ndarray) -> np.ndarray:
    """Scalar qm31 x array: alpha=(a0..a3) ints, d uint64[m, 4] -> uint64[m, 4].
    Every product is reduced before summation so int64 never overflows."""
    a0, a1, a2, a3 = (int(x) for x in alpha)
    d0, d1, d2, d3 = (d[:, i] for i in range(4))
    m = lambda s, t: (s * t) % P31
    # all inputs to subtractions are pre-reduced; add P31 to stay unsigned
    c0 = (m(a0, d0) + P31 - m(a1, d1)) % P31
    c1 = (m(a0, d1) + m(a1, d0)) % P31
    dd0 = (m(a2, d2) + P31 - m(a3, d3)) % P31
    dd1 = (m(a2, d3) + m(a3, d2)) % P31
    e0 = (2 * dd0 + P31 - dd1) % P31
    e1 = (dd0 + 2 * dd1) % P31
    y0 = (m(a0, d2) + m(a2, d0) + 2 * P31 - m(a1, d3) - m(a3, d1)) % P31
    y1 = (m(a0, d3) + m(a1, d2) + m(a2, d1) + m(a3, d0)) % P31
    return np.stack([(c0 + e0) % P31, (c1 + e1) % P31, y0, y1], axis=1)


def _qm31_leaves(vals: np.ndarray) -> np.ndarray:
    """vals uint32[m, 4] -> uint8[m, 16] little-endian leaves."""
    out = np.zeros((vals.shape[0], 16), dtype=np.uint8)
    for c in range(4):
        for b in range(4):
            out[:, 4 * c + b] = (vals[:, c] >> (8 * b)) & 0xFF
    return out


@dataclass
class FriLayerOpening:
    value: tuple          # qm31 at the queried index
    pair_value: tuple     # qm31 at the fold partner index
    path: list
    pair_path: list


@dataclass
class FriProof:
    layer_roots: list     # merkle roots, one per committed layer
    last_value: tuple     # the final constant (qm31)
    pow_nonce: int
    openings: list        # [per query][per layer] FriLayerOpening
    log_n: int
    log_blowup: int


class FriContext:
    """Precomputed twiddle tables for a fixed domain size."""

    def __init__(self, log_n: int, log_blowup: int = 2, device=None):
        assert log_blowup >= 1 and log_n > log_blowup
        self.log_n = log_n
        self.log_blowup = log_blowup
        self.fft = CircleFFT(log_n)
        self.device = resolve_device(device)     # where merkle.commit hashes
        n = 1 << log_n
        ys = self.fft.domain_y[: n // 2]
        self.inv_y = np.array([pow(int(y), -1, P31) for y in ys],
                              dtype=np.uint32)
        self.inv_x_levels = [np.array([pow(int(x), -1, P31) for x in lvl],
                                      dtype=np.uint32)
                             for lvl in self.fft._x_levels]
        self.n_folds = log_n - log_blowup

    def _fold_twiddle(self, k: int) -> np.ndarray:
        return self.inv_y if k == 0 else self.inv_x_levels[k - 1]

    @staticmethod
    def _pair_index(i: int, m: int, k: int) -> int:
        if k == 0:
            return i + m // 2 if i < m // 2 else i - m // 2
        return m - 1 - i

    @staticmethod
    def _next_index(i: int, m: int, k: int) -> int:
        if k == 0:
            return i if i < m // 2 else i - m // 2
        return min(i, m - 1 - i)

    # ---- prover ----

    def prove(self, evals: np.ndarray, channel: Channel,
              n_queries: int = 20, pow_bits: int = 10,
              return_queries: bool = False):
        """evals: uint32[N, 4] QM31 evaluations on the circle domain.

        With return_queries=True, returns (proof, queries) so a caller
        protocol (the STARK prover) can open other commitments at the same
        positions — the ALI consistency checks ride the FRI queries."""
        n = 1 << self.log_n
        assert evals.shape == (n, 4)
        layers = []
        trees = []
        cur = evals.astype(np.uint64)
        for k in range(self.n_folds):
            tree = merkle.commit(_qm31_leaves(cur.astype(np.uint32)),
                                 self.device)
            trees.append(tree)
            layers.append(cur.astype(np.uint32))
            channel.mix_bytes(tree.root)
            alpha = channel.draw_qm31()
            af = (alpha[0][0], alpha[0][1], alpha[1][0], alpha[1][1])
            m = cur.shape[0]
            tw = self._fold_twiddle(k).astype(np.uint64)
            if k == 0:
                a, b = cur[: m // 2], cur[m // 2:]
            else:
                a, b = cur[: m // 2], cur[m // 2:][::-1]
            s = (a + b) * INV2 % P31
            d = (a + P31 - b) % P31 * INV2 % P31 * tw[:, None] % P31
            cur = (s + _qm_mul_scalar_np(af, d)) % P31
        # final layer must be constant for honest provers
        last = tuple(int(x) for x in cur[0])
        channel.mix_felts([*last])
        nonce = channel.grind_pow(pow_bits)
        queries = channel.draw_queries(n_queries, self.log_n)
        openings = []
        for q in queries:
            per_layer = []
            idx = q
            for k in range(self.n_folds):
                layer = layers[k]
                m = layer.shape[0]
                pair = self._pair_index(idx, m, k)
                per_layer.append(FriLayerOpening(
                    value=tuple(int(x) for x in layer[idx]),
                    pair_value=tuple(int(x) for x in layer[pair]),
                    path=trees[k].open(idx),
                    pair_path=trees[k].open(pair),
                ))
                idx = self._next_index(idx, m, k)
            openings.append(per_layer)
        proof = FriProof(layer_roots=[t.root for t in trees], last_value=last,
                         pow_nonce=nonce, openings=openings,
                         log_n=self.log_n, log_blowup=self.log_blowup)
        return (proof, queries) if return_queries else proof

    # ---- verifier (host) ----

    def verify(self, proof: FriProof, channel: Channel,
               n_queries: int = 20, pow_bits: int = 10,
               layer0_expected=None) -> bool:
        """layer0_expected: optional callable (query_index) -> qm31 tuple;
        when given, the opened layer-0 value at each query must equal it
        (binds the FRI word to an outer ALI/consistency computation)."""
        if proof.log_n != self.log_n or proof.log_blowup != self.log_blowup:
            return False
        if len(proof.layer_roots) != self.n_folds:
            return False
        alphas = []
        for root in proof.layer_roots:
            channel.mix_bytes(root)
            a = channel.draw_qm31()
            alphas.append((a[0][0], a[0][1], a[1][0], a[1][1]))
        channel.mix_felts([*proof.last_value])
        if not channel.check_pow(proof.pow_nonce, pow_bits):
            return False
        channel.mix_pow_nonce(proof.pow_nonce)
        queries = channel.draw_queries(n_queries, self.log_n)
        if len(proof.openings) != len(queries):
            return False
        for q, per_layer in zip(queries, proof.openings):
            idx = q
            expected = None
            if layer0_expected is not None:
                want = tuple(int(x) for x in layer0_expected(q))
                if tuple(per_layer[0].value) != want:
                    return False
            for k in range(self.n_folds):
                m = 1 << (self.log_n - k)
                opening = per_layer[k]
                pair = self._pair_index(idx, m, k)
                root = proof.layer_roots[k]
                if not merkle.verify_path(root, idx,
                                          _leaf_bytes(opening.value),
                                          opening.path):
                    return False
                if not merkle.verify_path(root, pair,
                                          _leaf_bytes(opening.pair_value),
                                          opening.pair_path):
                    return False
                if expected is not None and opening.value != expected:
                    return False
                # recompute the fold
                lo_idx = min(idx, pair) if k else idx % (m // 2)
                if k == 0:
                    a_val = opening.value if idx < m // 2 else opening.pair_value
                    b_val = opening.pair_value if idx < m // 2 else opening.value
                    tw = int(self.inv_y[lo_idx])
                else:
                    a_pos_is_idx = idx < m // 2
                    a_val = opening.value if a_pos_is_idx else opening.pair_value
                    b_val = opening.pair_value if a_pos_is_idx else opening.value
                    tw = int(self.inv_x_levels[k - 1][lo_idx])
                s = _qm_scale(_qm_add(a_val, b_val), INV2)
                d = _qm_scale(_qm_sub(a_val, b_val), INV2 * tw % P31)
                expected = _qm_add(s, _qm_mul(alphas[k], d))
                idx = self._next_index(idx, m, k)
            if expected != proof.last_value:
                return False
        return True

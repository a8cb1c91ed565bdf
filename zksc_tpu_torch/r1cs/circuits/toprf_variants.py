"""TOPRF cipher-circuit variants: chacha20-toprf, aes-128/256-ctr-toprf.

Statement parity with the reference's OPRF circuits
(gnark/circuits/chachaV3_oprf/chacha.go:13-40 and
gnark/circuits/aesV2_oprf/aes.go:10-37 — studied, composed fresh here):

  - the cipher statement is unchanged (keystream XOR in == out), but the
    plaintext `out` becomes PRIVATE — the proof reveals only that the bytes
    selected by a public bitmask hash (via TOPRF) to a public output
  - public additions: bitmask (one bit per plaintext bit), len (number of
    secret bytes), and the TOPRF verification parameters (domain separator,
    per-share responses/public keys/DLEQ (c, r), Lagrange coefficients,
    output)
  - private additions: the plaintext bits and the OPRF mask scalar

Bit order: our circuits keep in/out bits in byte-stream order (LSB-first per
byte), which is exactly the order the reference flattens to before
ExtractSecretElements (chacha.go:29-37 endianness switch) — so the cipher
output bits feed the TOPRF gadget with zero rewiring.
"""
from __future__ import annotations

from . import toprf as toprf_gadget


def _cipher_module(algorithm: str):
    if algorithm.startswith("chacha20"):
        from . import chacha20
        return chacha20
    from . import aes
    return aes


def base_algorithm(algorithm: str) -> str:
    assert algorithm.endswith("-toprf"), algorithm
    return algorithm[: -len("-toprf")]


def public_layout(algorithm: str, blocks: int):
    """Per block: counter, nonce, in (ciphertext). Then bitmask, len, and the
    TOPRF public parameters. Plaintext (out) is NOT public."""
    mod = _cipher_module(algorithm)
    layout = []
    for b in range(blocks):
        layout += [
            (f"counter{b}", mod.COUNTER_BITS),
            (f"nonce{b}", mod.NONCE_BITS),
            (f"in{b}", mod.BLOCK_BITS),
        ]
    total_bits = blocks * mod.BLOCK_BITS
    layout += [("bitmask", total_bits), ("len", 1)]
    layout += list(toprf_gadget.TOPRF_PUBLIC_LAYOUT)
    return layout


def private_layout(algorithm: str, blocks: int, key_bits: int):
    mod = _cipher_module(algorithm)
    layout = [("key", key_bits)]
    for b in range(blocks):
        layout += [(f"out{b}", mod.BLOCK_BITS)]
    layout += list(toprf_gadget.TOPRF_PRIVATE_LAYOUT)
    return layout


def make_define(algorithm: str, blocks: int, key_bits: int):
    mod = _cipher_module(algorithm)
    if algorithm.startswith("chacha20"):
        cipher_define = mod.make_define(blocks)
    else:
        cipher_define = mod.make_define(blocks, key_bits)

    def define(api, v):
        cipher_define(api, v)
        out_bits = []
        for b in range(blocks):
            out_bits += list(v[f"out{b}"])
        s0, s1 = toprf_gadget.extract_secret_elements(
            api, out_bits, v["bitmask"], v["len"][0])
        params = toprf_gadget.params_from_vars(v)
        toprf_gadget.verify_toprf(api, params, s0, s1)

    return define


def witness_inputs(algorithm: str, keys: list, block_infos: list, ins: list,
                   outs: list, blocks: int, bitmasks: list, lens: list,
                   toprf_pubs: list, masks: list):
    """Assemble (public_values, private_values) for a batch.

    bitmasks: [batch][total_bits] 0/1; lens: [batch] byte counts;
    toprf_pubs/masks: per-proof TOPRF public dicts (from
    toprf.toprf_witness_values with batch=1) and mask ints.
    """
    mod = _cipher_module(algorithm)
    base_pub, base_priv = mod.witness_inputs(keys, block_infos, ins, outs,
                                             blocks)
    batch = len(keys)
    pub, priv = {}, dict(base_priv)
    for name, _count in [(f"counter{b}", 0) for b in range(blocks)] + \
                        [(f"nonce{b}", 0) for b in range(blocks)] + \
                        [(f"in{b}", 0) for b in range(blocks)]:
        pub[name] = base_pub[name]
    for b in range(blocks):
        priv[f"out{b}"] = base_pub[f"out{b}"]
    total_bits = blocks * mod.BLOCK_BITS
    pub["bitmask"] = [[bitmasks[j][i] for j in range(batch)]
                      for i in range(total_bits)]
    pub["len"] = [[lens[j] for j in range(batch)]]
    # merge the per-proof TOPRF dicts along the batch axis
    t0 = toprf_pubs[0]
    for name, _cnt in toprf_gadget.TOPRF_PUBLIC_LAYOUT:
        cnt = len(t0[name])
        pub[name] = [[int(toprf_pubs[j][name][i][0]) for j in range(batch)]
                     for i in range(cnt)]
    priv["toprf_mask"] = [[int(masks[j]) for j in range(batch)]]
    return pub, priv

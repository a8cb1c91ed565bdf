"""Wire formats of the port's proofs and keys, and the reference's formats
(SURVEY.md §2.5 item 8), as in the JAX package's ``interop/``:

- ``bincode``: the stwo proof envelope of the stark engines.
- ``gnark``: gnark-crypto compressed G1/G2 points, Groth16 verifying keys
  and proofs.
- ``gnark_r1cs``: gnark v0.14 R1CS binaries, their witness solver and their
  conversion to the port's ConstraintSystem, with ``cbor`` and ``intcomp``
  as its decoders.
- ``snarkjs``: .zkey / .wtns containers and the vkey JSON.
- ``circom_wasm`` / ``stwo_wasm``: circom's witness calculator and the
  reference stwo module, run in the native WASM VM (``native.wasm_lib``).
"""

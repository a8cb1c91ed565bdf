"""zksc_tpu_torch — PyTorch / CUDA port of zksc_tpu for one NVIDIA H100.

Proves in zero knowledge that a symmetric key decrypts a TLS ciphertext chunk
(ChaCha20, Groth16 over BN254), with the prover's bucket MSMs running through
hand-written CUDA kernels (csrc/) and the rest as plain PyTorch tensor code.
The JAX package `zksc_tpu` is the reference this port is held against; this
package imports nothing from it.
"""
__version__ = "0.1.0"

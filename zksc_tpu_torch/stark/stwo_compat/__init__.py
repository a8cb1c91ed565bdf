"""The ``stark-stwo`` engine: byte-exact stwo proofs of the ChaCha20 stream
statement (stwo @ f117d48), ported from the JAX package's
``stark/stwo_compat/``.

The host modules are copies (``field``, ``circle``, ``channel``, ``codec``,
``quotients``, ``fri``, the host half of ``merkle``, the QM31 walk of
``air``, ``verifier``); "NOTES.md" in them is the derivation log at
``zksc_tpu/stark/stwo_compat/NOTES.md``. Everything that scales with the
trace runs on tensors (``trace``, ``cfft``, ``air.layout``, ``prover``): on
the card through K7a (Blake2s), K7b (circle FFT layers) and K7c (the
composition), on the CPU through their plain PyTorch versions.
"""
from .codec import decode_stream_proof, encode_stream_proof  # noqa: F401
from .channel import Blake2sChannel  # noqa: F401

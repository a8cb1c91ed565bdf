"""Wire formats of the port's proofs."""

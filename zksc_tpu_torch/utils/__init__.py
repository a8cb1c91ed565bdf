"""Host-only helpers: Keccak-256 for the MiMC constants, structured
logging and trace spans."""

"""The Circle-STARK engine ("stark") over M31, for the chacha20 stream AIR and
the AES-CTR LogUp S-box AIR."""

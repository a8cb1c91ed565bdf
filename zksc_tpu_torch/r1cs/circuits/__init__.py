from . import aes, chacha20, toprf, toprf_variants

__all__ = ["aes", "chacha20", "toprf", "toprf_variants"]

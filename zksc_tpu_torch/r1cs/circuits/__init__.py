from . import aes, chacha20

__all__ = ["aes", "chacha20"]

from . import chacha20

__all__ = ["chacha20"]

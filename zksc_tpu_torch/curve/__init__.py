from . import bn254_host

__all__ = ["bn254_host"]

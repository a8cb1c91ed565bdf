from .limb import LimbField, Fp, Fr, BN254_P, BN254_R, int_to_limbs

__all__ = [
    "LimbField", "Fp", "Fr", "BN254_P", "BN254_R", "int_to_limbs",
]

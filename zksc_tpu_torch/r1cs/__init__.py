from .builder import (
    ConstraintSystem, R1CSBuilder, WitnessBuilder, check_witness,
    compile_circuit, generate_witness,
)

__all__ = [
    "ConstraintSystem", "R1CSBuilder", "WitnessBuilder", "check_witness",
    "compile_circuit", "generate_witness",
]

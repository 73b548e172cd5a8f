"""R1CS front end: linear combinations, the constraint system and the flat
COO `R1csShape` (the port's own copies of the JAX package's `r1cs/`)."""

from .lc import ONE, LinearCombination, Variable
from .system import (
    ConstraintSystem,
    ConstraintSynthesizer,
    R1csShape,
    SynthesisError,
    SynthesisMode,
    synthesize,
)

__all__ = [
    "ONE",
    "LinearCombination",
    "Variable",
    "ConstraintSystem",
    "ConstraintSynthesizer",
    "R1csShape",
    "SynthesisError",
    "SynthesisMode",
    "synthesize",
]

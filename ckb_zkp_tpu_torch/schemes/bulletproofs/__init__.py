# Copied from ckb_zkp_tpu/schemes/bulletproofs/__init__.py (the package's exports): the port keeps its own copy.
"""Bulletproofs arithmetic-circuit proofs ("protocol3") over R1CS.

Parity: ckb-zkp bulletproofs/src/ — same transcript schedule
(merlin "protocol3"), same degree-5/10 vector polynomials (T_4 is the
statement slot and is not committed), same log-size inner-product argument
("protocol2") with the dalek s-vector verifier optimization.
"""

from .arithmetic_circuit import (
    Generators,
    Proof,
    R1csCircuit,
    create_random_proof,
    prove,
    verify_proof,
)
from . import inner_product_proof

__all__ = [
    "Generators",
    "Proof",
    "R1csCircuit",
    "create_random_proof",
    "prove",
    "verify_proof",
    "inner_product_proof",
]

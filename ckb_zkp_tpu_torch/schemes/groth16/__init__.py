"""Groth16 on PyTorch/CUDA: setup, prover and verifier.

Parity with the reference package's `schemes/groth16`: the setup (device
and host branches), the device branch of the prover, and the verifier and
key/proof types (the port's copies of the reference's host-int files).
"""

from .generator import generate_parameters_from_shape
from .prover import create_proof_from_shape
from .types import Parameters, PreparedVerifyingKey, Proof, VerifyKey
from .verifier import prepare_verifying_key, verify_proof

__all__ = [
    "Parameters",
    "PreparedVerifyingKey",
    "Proof",
    "VerifyKey",
    "generate_parameters_from_shape",
    "create_proof_from_shape",
    "prepare_verifying_key",
    "verify_proof",
]

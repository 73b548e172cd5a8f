"""Groth16 on PyTorch/CUDA: setup, prover, verifier and key/proof bytes.

Parity with the reference package's `schemes/groth16` on BN254 and
BLS12-381: the front ends (`generate_random_parameters`,
`generate_parameters`, `create_random_proof`, `create_proof`,
`create_proof_no_zk`), the setup (device and host branches), the device
branch of the prover, the verifier and key/proof types (the port's copies
of the reference's host-int files), and the ark-0.2 bytes of keys and
proofs (`serialize`).
"""

from .generator import (
    generate_parameters,
    generate_parameters_from_shape,
    generate_random_parameters,
)
from .prover import (
    create_proof,
    create_proof_from_shape,
    create_proof_no_zk,
    create_random_proof,
)
from .types import Parameters, PreparedVerifyingKey, Proof, VerifyKey
from .verifier import prepare_verifying_key, verify_proof

__all__ = [
    "Parameters",
    "PreparedVerifyingKey",
    "Proof",
    "VerifyKey",
    "generate_parameters",
    "generate_parameters_from_shape",
    "generate_random_parameters",
    "create_proof",
    "create_proof_from_shape",
    "create_random_proof",
    "create_proof_no_zk",
    "prepare_verifying_key",
    "verify_proof",
]

"""Groth16 on PyTorch/CUDA: setup, prover, and the reference's verifier.

Parity with the reference package's `schemes/groth16` (setup and the
device branch of the prover); the verifier and the key/proof types are the
reference's own jax-free files, loaded through `ckb_zkp_tpu_torch._reference`.
"""

from ..._reference import (
    Parameters,
    PreparedVerifyingKey,
    Proof,
    VerifyKey,
    prepare_verifying_key,
    verify_proof,
)
from .generator import generate_parameters_from_shape
from .prover import create_proof_from_shape

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

"""Marlin universal-SRS zkSNARK: AHP for R1CS + KZG10 polynomial commitments.

Port of the reference's `schemes/marlin` (ckb-zkp marlin/src/):
universal_setup / index / create_random_proof / verify_proof with the same
12 indexer + 9 prover polynomials, 3 prover rounds, degree-bound shifted
commitments for g_1/g_2, and the digest-chained ChaCha20 Fiat-Shamir RNG.
"""

from .marlin import (
    IndexProverKey,
    IndexVerifierKey,
    Proof,
    create_random_proof,
    index,
    universal_setup,
    verify_proof,
)

__all__ = [
    "IndexProverKey",
    "IndexVerifierKey",
    "Proof",
    "create_random_proof",
    "index",
    "universal_setup",
    "verify_proof",
]

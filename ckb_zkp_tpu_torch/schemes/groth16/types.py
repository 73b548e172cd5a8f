# Copied from ckb_zkp_tpu/schemes/groth16/types.py (host ints and numpy only): the port keeps its own copy.
"""Groth16 key and proof types.

Parity: Proof/VerifyKey/Parameters/PreparedVerifyingKey
(ckb-zkp groth16/src/lib.rs:51-102). Query vectors live on device as
Jacobian point arrays (ready for the prover MSMs); vk elements are host
affine points (verifier is the O(1) host path).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ...host.curves import AffinePoint
from ...host.pairing import PairingCurve
from ...host.tower import Fq12E


@dataclass
class Proof:
    a: AffinePoint  # G1
    b: AffinePoint  # G2
    c: AffinePoint  # G1

    def __eq__(self, other):
        return (self.a, self.b, self.c) == (other.a, other.b, other.c)


@dataclass
class VerifyKey:
    alpha_g1: AffinePoint
    beta_g2: AffinePoint
    gamma_g2: AffinePoint
    delta_g2: AffinePoint
    gamma_abc_g1: list[AffinePoint]


@dataclass
class PreparedVerifyingKey:
    vk: VerifyKey
    alpha_g1_beta_g2: Fq12E  # e(alpha, beta), precomputed
    neg_gamma_g2: AffinePoint
    neg_delta_g2: AffinePoint


@dataclass
class Parameters:
    """Proving key: vk + device-resident query vectors."""

    curve: PairingCurve
    vk: VerifyKey
    beta_g1: AffinePoint
    delta_g1: AffinePoint
    domain_size: int
    # device Jacobian point arrays (X, Y, Z), leading axis = query length
    a_query: Any  # G1, len = num_vars
    b_g1_query: Any  # G1, len = num_vars
    b_g2_query: Any  # G2, len = num_vars
    h_query: Any  # G1, len = domain_size - 1
    l_query: Any  # G1, len = num_aux
    num_inputs: int = 0
    num_aux: int = 0
    num_constraints: int = 0
    # True when query arrays carry pow2 padding (infinity rows): a/b queries
    # padded to next_pow2(num_vars) (l_query same length, inputs zeroed),
    # h_query padded to domain_size. Shape-stable arrays share compiled
    # graphs; the serializer slices back to logical lengths.
    padded_queries: bool = False

# Copied from ckb_zkp_tpu/schemes/groth16/verifier.py (host ints and numpy only): the port keeps its own copy.
"""Groth16 verifier (host, exact).

Parity: prepare_verifying_key / verify_proof
(ckb-zkp groth16/src/verifier.rs:8-44): product of a 3-pair Miller
loop compared against the precomputed e(alpha, beta).
"""

from __future__ import annotations

from ...host.pairing import PairingCurve
from .types import Parameters, PreparedVerifyingKey, Proof, VerifyKey


def prepare_verifying_key(curve: PairingCurve, vk: VerifyKey) -> PreparedVerifyingKey:
    return PreparedVerifyingKey(
        vk=vk,
        alpha_g1_beta_g2=curve.pairing(vk.alpha_g1, vk.beta_g2),
        neg_gamma_g2=curve.g2.neg(vk.gamma_g2),
        neg_delta_g2=curve.g2.neg(vk.delta_g2),
    )


def verify_proof(
    curve: PairingCurve,
    pvk: PreparedVerifyingKey,
    proof: Proof,
    public_inputs: list[int],
) -> bool:
    vk = pvk.vk
    if len(public_inputs) + 1 != len(vk.gamma_abc_g1):
        return False
    g1 = curve.g1
    g_ic = vk.gamma_abc_g1[0]
    for x, b in zip(public_inputs, vk.gamma_abc_g1[1:]):
        g_ic = g1.add(g_ic, g1.mul(b, x % curve.fr.modulus))
    # e(A, B) * e(g_ic, -gamma) * e(C, -delta) == e(alpha, beta)
    result = curve.product_of_pairings(
        [
            (proof.a, proof.b),
            (g_ic, pvk.neg_gamma_g2),
            (proof.c, pvk.neg_delta_g2),
        ]
    )
    return result == pvk.alpha_g1_beta_g2

"""The port's own copies of the JAX package's host layers (fields, curves,
pairings, R1CS, benchmark circuits, Groth16 types and verifier, the ark-0.2
codecs and the Mini circuit) against the originals: each exact copy's text
is its original's under a header naming it, and the same circuits array
for array, the same curve arithmetic, and the same verifier verdicts."""

import os
import re

import numpy as np
import pytest

from ckb_zkp_tpu import bench_circuits as ref_circuits
from ckb_zkp_tpu.host.pairing import get_curve
from ckb_zkp_tpu.schemes import groth16 as ref_groth16
from ckb_zkp_tpu.schemes.groth16.qap import QapMatrices as RefQap
from ckb_zkp_tpu_torch import bench_circuits as port_circuits
from ckb_zkp_tpu_torch.convert import point_from_reference
from ckb_zkp_tpu_torch.host.pairing import get_curve as port_curve
from ckb_zkp_tpu_torch.r1cs import R1csShape
from ckb_zkp_tpu_torch.schemes import groth16
from ckb_zkp_tpu_torch.schemes.groth16.types import Proof

CURVE = get_curve("bn254")
FR = CURVE.fr.modulus
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the copies kept word for word (r1cs/system.py leaves out the witness cache)
EXACT_COPIES = ("host/curves.py", "host/field.py", "host/pairing.py", "host/tower.py",
                "r1cs/lc.py", "bench_circuits.py", "schemes/groth16/types.py",
                "schemes/groth16/verifier.py", "serialize/ark.py", "circuits/mini.py")


@pytest.mark.parametrize("path", EXACT_COPIES)
def test_copy_matches_its_original(path):
    """The copy is a header line naming its original, then the original's
    text, where the original's absolute paths to the Rust sources read
    `ckb-zkp <path>`."""
    with open(os.path.join(REPO, "ckb_zkp_tpu", path)) as f:
        original = f.read()
    with open(os.path.join(REPO, "ckb_zkp_tpu_torch", path)) as f:
        header, _, copy = f.read().partition("\n")
    assert header.startswith(f"# Copied from ckb_zkp_tpu/{path} ")
    assert copy == re.sub(r"(/\w+)+/reference/", "ckb-zkp ", original)


@pytest.mark.parametrize("circuit,n", [("square_chain_shape", 62),
                                       ("product_circuit_shape", 20)])
def test_circuits_equal_the_reference_array_for_array(circuit, n):
    want = getattr(ref_circuits, circuit)(n, FR, seed=9)
    got = getattr(port_circuits, circuit)(n, FR, seed=9)
    assert isinstance(got, R1csShape)
    for k in ("num_inputs", "num_aux", "num_constraints", "p",
              "input_assignment", "aux_assignment"):
        assert getattr(got, k) == getattr(want, k), k
    for mat in ("a", "b", "c"):
        g, w = getattr(got, mat), getattr(want, mat)
        assert np.array_equal(g.rows, w.rows) and g.rows.dtype == w.rows.dtype
        assert np.array_equal(g.cols, w.cols) and g.cols.dtype == w.cols.dtype
        assert g.coeffs == w.coeffs
    assert not hasattr(got, "witness_limbs")


def test_curve_arithmetic_equals_the_reference():
    pc = port_curve("bn254")
    rng = np.random.default_rng(11)
    for k in (int(x) for x in rng.integers(1, 1 << 62, size=3)):
        for g, pg, gen, pgen in ((CURVE.g1, pc.g1, CURVE.g1_gen, pc.g1_gen),
                                 (CURVE.g2, pc.g2, CURVE.g2_gen, pc.g2_gen)):
            want, got = g.mul(gen, k), pg.mul(pgen, k)
            assert (got.x, got.y, got.infinity) == (want.x, want.y, want.infinity)
    assert (pc.fr.modulus, pc.fq.modulus) == (CURVE.fr.modulus, CURVE.fq.modulus)


def test_port_verifier_gives_the_reference_verdicts():
    shape = ref_circuits.square_chain_shape(30, FR)
    params = ref_groth16.generate_parameters_from_shape(
        shape, CURVE, 5, 6, 7, 8, 9, host_mode=True)
    # the reference's host-int prover (no witness-map compiles): the same proof
    proof = ref_groth16.create_proof_from_shape(
        params, shape, 3, 4, qap=RefQap(shape, CURVE.fr, host_mode=True))
    publics = shape.input_assignment[1:]
    pc = port_curve("bn254")
    pt = point_from_reference
    vk = groth16.VerifyKey(
        alpha_g1=pt(params.vk.alpha_g1), beta_g2=pt(params.vk.beta_g2),
        gamma_g2=pt(params.vk.gamma_g2), delta_g2=pt(params.vk.delta_g2),
        gamma_abc_g1=[pt(g) for g in params.vk.gamma_abc_g1])
    pvk = groth16.prepare_verifying_key(pc, vk)
    rpvk = ref_groth16.prepare_verifying_key(CURVE, params.vk)
    port_proof = Proof(a=pt(proof.a), b=pt(proof.b), c=pt(proof.c))
    swapped = Proof(a=pt(proof.a), b=pt(proof.b), c=pt(proof.a))
    ref_swapped = type(proof)(a=proof.a, b=proof.b, c=proof.a)
    for p_proof, r_proof, pubs in (
        (port_proof, proof, publics),
        (port_proof, proof, [(publics[0] + 1) % FR]),
        (swapped, ref_swapped, publics),
    ):
        want = ref_groth16.verify_proof(CURVE, rpvk, r_proof, pubs)
        assert groth16.verify_proof(pc, pvk, p_proof, pubs) == want
    assert ref_groth16.verify_proof(CURVE, rpvk, proof, publics) is True

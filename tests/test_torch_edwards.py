"""Bulletproofs and Spartan NIZK over jubjub and baby jubjub through the
port, against the JAX package's host-int run.

As `tests/test_jubjub.py` runs them: the Mini circuit, Bulletproofs from
`random.Random(77)` and the NIZK from `random.Random(55)`, both packages
from the same seed. The Edwards groups stay on the host (`is_edwards`),
so both runs draw the same randomness: the setup's and the proof's ark
bytes (the Edwards `PT` branch) equal the JAX package's, the port verifies
its proof and the one the JAX package made, decoded from its bytes, and
refuses a changed public input.

Tolerance: none (bytes and verdicts are exact). The JAX package runs its
host paths only."""

import random

import pytest
import torch

from ckb_zkp_tpu.circuits import Mini as RefMini
from ckb_zkp_tpu.host import edwards_groups as ref_edwards
from ckb_zkp_tpu.schemes import bulletproofs as ref_bp
from ckb_zkp_tpu.schemes.spartan import nizk as ref_nizk
from ckb_zkp_tpu.serialize import ark_schemes as ref_ark
from ckb_zkp_tpu_torch.circuits import Mini
from ckb_zkp_tpu_torch.host import edwards_groups
from ckb_zkp_tpu_torch.schemes import bulletproofs as bp
from ckb_zkp_tpu_torch.schemes.spartan import nizk
from ckb_zkp_tpu_torch.serialize.ark_schemes import S, Tup, ark_decode, ark_encode

torch.set_num_threads(1)
EDWARDS = ("jubjub", "baby_jubjub")


@pytest.mark.parametrize("name", EDWARDS)
def test_bulletproofs_over_edwards_equal_the_reference(name):
    rc, c = ref_edwards.get_edwards_curve(name), edwards_groups.get_edwards_curve(name)
    want = ref_bp.create_random_proof(rc, RefMini.power_on(2, 3, 10), random.Random(77))
    gens, r1cs, proof = bp.create_random_proof(c, Mini.power_on(2, 3, 10), random.Random(77),
                                               device="cpu")
    cell = Tup(S(bp.Generators), S(bp.R1csCircuit), S(bp.Proof))
    raw = ark_encode(c, (gens, r1cs, proof), cell)
    assert raw == ref_ark.ark_encode(rc, want, ref_ark.Tup(
        ref_ark.S(ref_bp.Generators), ref_ark.S(ref_bp.R1csCircuit), ref_ark.S(ref_bp.Proof)))
    assert ark_encode(c, ark_decode(c, raw, cell, device="cpu"), cell) == raw

    from_ref = ark_decode(c, ref_ark.ark_encode(rc, want[2]), bp.Proof, device="cpu")
    assert bp.verify_proof(c, gens, from_ref, r1cs, [10]) is True
    assert bp.verify_proof(c, gens, proof, r1cs, [11]) is False


@pytest.mark.parametrize("name", EDWARDS)
def test_spartan_nizk_over_edwards_equals_the_reference(name):
    rc, c = ref_edwards.get_edwards_curve(name), edwards_groups.get_edwards_curve(name)
    rng = random.Random(55)
    rr1cs = ref_nizk.generate_r1cs(rc, RefMini.power_off())
    rparams = ref_nizk.generate_setup_parameters(rc, rng, rr1cs.num_aux, rr1cs.num_inputs)
    rhashes = (rr1cs.r1cs_to_hash(), ref_nizk.params_to_hash(rc, rparams))
    rproof = ref_nizk.create_nizk_proof(rc, rparams, rr1cs, RefMini.power_on(2, 3, 10),
                                        *rhashes, rng)

    rng = random.Random(55)
    r1cs = nizk.generate_r1cs(c, Mini.power_off())
    params = nizk.generate_setup_parameters(c, rng, r1cs.num_aux, r1cs.num_inputs, device="cpu")
    hashes = (r1cs.r1cs_to_hash(), nizk.params_to_hash(c, params))
    proof = nizk.create_nizk_proof(c, params, r1cs, Mini.power_on(2, 3, 10), *hashes, rng,
                                   device="cpu")
    assert hashes == rhashes
    assert ark_encode(c, params) + ark_encode(c, r1cs) == \
        ref_ark.ark_encode(rc, rparams) + ref_ark.ark_encode(rc, rr1cs)
    want = ref_ark.ark_encode(rc, rproof)
    assert ark_encode(c, proof) == want

    from_ref = ark_decode(c, want, nizk.NIZKProof, device="cpu")
    assert nizk.verify_nizk_proof(c, params, r1cs, [10], from_ref, *hashes, device="cpu") is True
    assert nizk.verify_nizk_proof(c, params, r1cs, [11], proof, *hashes, device="cpu") is False

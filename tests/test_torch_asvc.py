"""The port's aSVC on BLS12-381 on the CPU, against the JAX package, as
`tests/test_asvc.py` drives it: n = 8, `random.Random(17)`, 8 random
values.

`key_gen` from the same seed equals the JAX package's field by field: the
G1 powers and the Lagrange commitments limb for limb after the repack of
`convert.asvc_params_from_reference`, the update keys, `a`, and the G2
powers, which the port computes with the G2 fixed-base MSM (K6's plain
version here) where the JAX package multiplies on the host, power by
power. `commit`, `prove_pos` and `aggregate_proofs` give the JAX
package's points; every verdict of the five JAX tests holds (a swapped
value and a wrong update key refused); a proof made over
`asvc_params_from_reference(...)` equals the JAX package's. Tolerance:
none (integers and points are exact). JAX runs eagerly."""

import random

import pytest
import torch

from ckb_zkp_tpu.host.pairing import get_curve as ref_curve
from ckb_zkp_tpu.schemes import asvc as ref_asvc
from ckb_zkp_tpu_torch.convert import asvc_params_from_reference, point_from_reference
from ckb_zkp_tpu_torch.host.pairing import get_curve
from ckb_zkp_tpu_torch.schemes import asvc

torch.set_num_threads(1)
CURVE = get_curve("bls12_381")
P = CURVE.fr.modulus
pt = point_from_reference


@pytest.fixture(scope="module")
def runs():
    ref_rng, rng = random.Random(17), random.Random(17)
    ref_params = ref_asvc.key_gen(ref_curve("bls12_381"), 8, ref_rng)
    timings: dict = {}
    params = asvc.key_gen(CURVE, 8, rng, device="cpu", timings=timings)
    assert rng.getstate() == ref_rng.getstate()
    values = [rng.randrange(P) for _ in range(8)]
    assert values == [ref_rng.randrange(P) for _ in range(8)]
    return {"ref": ref_params, "params": params, "values": values, "timings": timings,
            "ref_c": ref_asvc.commit(ref_params, values), "c": asvc.commit(params, values)}


def test_key_gen_equals_the_reference(runs):
    ref, params = runs["ref"], runs["params"]
    want = asvc_params_from_reference(ref, "cpu")
    assert (params.n, params.omega) == (want.n, want.omega) == (8, ref.omega)
    for got, exp in ((params.proving_key.powers_of_g1, want.proving_key.powers_of_g1),
                     (params.proving_key.l_of_g1, want.proving_key.l_of_g1),
                     (params.verification_key.powers_of_g1, want.verification_key.powers_of_g1)):
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, exp))
    assert params.proving_key.powers_of_g1[0].shape == (9, 24)
    assert params.proving_key.l_of_g1[0].shape == (8, 24)
    assert params.proving_key.update_keys == want.proving_key.update_keys
    assert params.verification_key.a == want.verification_key.a
    # the device G2 powers are the JAX package's host loop's points
    g2 = params.verification_key.powers_of_g2
    assert len(g2) == 9 and g2 == [pt(q) for q in ref.verification_key.powers_of_g2]
    assert set(runs["timings"]) == {
        "tau_powers", "tables", "fixed_base_g1_powers", "fixed_base_g2_powers",
        "decode_g2_powers", "update_scalars", "fixed_base_update_keys", "decode_update_keys"}


def test_commit_equals_the_reference(runs):
    assert runs["c"].commit == pt(runs["ref_c"].commit)


def test_prove_verify_positions(runs):
    params, values, c = runs["params"], runs["values"], runs["c"]
    points = [0, 1, 5]
    proof = asvc.prove_pos(params, values, points)
    assert proof.w == pt(ref_asvc.prove_pos(runs["ref"], values, points).w)
    assert asvc.verify_pos(params, c, [values[i] for i in points], points, proof) is True
    assert asvc.verify_pos(params, c, [values[1], values[0], values[5]], points, proof) is False


def test_verify_upk(runs):
    params = runs["params"]
    assert asvc.verify_upk(params, 2, params.proving_key.update_keys[2]) is True
    assert asvc.verify_upk(params, 3, params.proving_key.update_keys[2]) is False


def test_update_same_position(runs):
    params, values, c = runs["params"], runs["values"], runs["c"]
    index, delta = 3, random.Random(31).randrange(P)
    uk = params.proving_key.update_keys[index]
    uc = asvc.update_commit(params, c, delta, index, uk)
    proof = asvc.prove_pos(params, values, [index])
    proof = asvc.update_proof(params, proof, delta, index, index, uk, uk)
    assert asvc.verify_pos(params, uc, [(values[index] + delta) % P], [index], proof)


def test_update_other_position(runs):
    params, values, c = runs["params"], runs["values"], runs["c"]
    i, j, delta = 4, 6, random.Random(32).randrange(P)
    uk_i = params.proving_key.update_keys[i]
    uk_j = params.proving_key.update_keys[j]
    uc = asvc.update_commit(params, c, delta, j, uk_j)
    proof = asvc.prove_pos(params, values, [i])
    proof = asvc.update_proof(params, proof, delta, i, j, uk_i, uk_j)
    assert asvc.verify_pos(params, uc, [values[i]], [i], proof)


def test_aggregate_equals_the_reference(runs):
    params, values, c, ref = runs["params"], runs["values"], runs["c"], runs["ref"]
    points = [2, 7]
    proofs = [asvc.prove_pos(params, values, [q]) for q in points]
    agg = asvc.aggregate_proofs(params, points, proofs)
    ref_proofs = [ref_asvc.Proof(q.w) for q in (ref_asvc.prove_pos(ref, values, [q])
                                                for q in points)]
    assert [q.w for q in proofs] == [pt(q.w) for q in ref_proofs]
    assert agg.w == pt(ref_asvc.aggregate_proofs(ref, points, ref_proofs).w)
    assert asvc.verify_pos(params, c, [values[i] for i in points], points, agg)


def test_proof_over_the_converted_params_equals_the_reference(runs):
    ref, values = runs["ref"], runs["values"]
    params = asvc_params_from_reference(ref, "cpu")
    proof = asvc.prove_pos(params, values, [6])
    assert proof.w == pt(ref_asvc.prove_pos(ref, values, [6]).w)

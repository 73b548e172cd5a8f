"""The port's prover on the reference's deserialized proving keys, on the
CPU. The reference's setup of `product_circuit_shape(200)` (nv 601, above
the reference's CPU padding cutoff of 512; m 256), run in host ints (its
host-mode instance map, and its fixed-base MSMs on the host while its
device groups' `small_host_threshold` is raised: the same points as its
device branch, without that branch's minute of XLA compiles), goes
through its `parameters_to_bytes` and `parameters_from_bytes`, which pad
the G1 and G2 queries to 1024 rows but h_query to m = 256 only, fewer
than the port's max(num_cols_pad, m) h scalars. The port cuts the h
scalars to the keys' rows: its proof equals, point for point, the
reference's on the same keys (the reference's host-int prover, which
reads the same padded keys), and its verifier accepts it; a nonzero h
scalar past the cut raises. Tolerance: none."""

import pytest
import torch
from test_torch_msm import reference_host_cutoff  # noqa: F401 (autouse)

from ckb_zkp_tpu.bench_circuits import product_circuit_shape
from ckb_zkp_tpu.host.pairing import get_curve
from ckb_zkp_tpu.ops.msm import device_group as ref_device_group
from ckb_zkp_tpu.schemes import groth16 as ref_groth16
from ckb_zkp_tpu.schemes.groth16.qap import QapMatrices as RefQap
from ckb_zkp_tpu.schemes.groth16.serialize import parameters_from_bytes, parameters_to_bytes
from ckb_zkp_tpu_torch import bench_circuits as port_circuits
from ckb_zkp_tpu_torch.convert import params_from_reference
from ckb_zkp_tpu_torch.schemes import groth16
from ckb_zkp_tpu_torch.schemes.groth16.qap import QapMatrices

torch.set_num_threads(1)
CURVE = get_curve("bn254")
FR = CURVE.fr.modulus
N = 200
TOXIC = (11, 12, 13, 14, 15)  # alpha, beta, gamma, delta, t
R, S = 3, 4


def _aff(p):
    return (True, None, None) if p.infinity else (False, p.x, p.y)


@pytest.fixture(scope="module")
def keys():
    """(reference shape, deserialized reference keys, the same keys in the
    port, the port's shape)."""
    shape = product_circuit_shape(N, FR)
    groups = [ref_device_group(CURVE, g) for g in ("g1", "g2")]
    cutoffs = [g.small_host_threshold for g in groups]
    try:
        for g in groups:
            g.small_host_threshold = 1 << 30
        fresh = ref_groth16.generate_parameters_from_shape(shape, CURVE, *TOXIC,
                                                           host_mode=True)
    finally:
        for g, c in zip(groups, cutoffs):
            g.small_host_threshold = c
    ref = parameters_from_bytes(CURVE, parameters_to_bytes(fresh))
    return shape, ref, params_from_reference(ref, "cpu"), port_circuits.product_circuit_shape(N, FR)


def _padded_layout(shape, ref):
    """The deserialized keys are padded, with h_query (m rows) narrower
    than the other G1 queries and than the port's h scalars."""
    nv = shape.num_inputs + shape.num_aux
    m = ref.domain_size
    rows = {name: getattr(ref, name)[0].shape[0] for name in ("a_query", "h_query")}
    return (ref.padded_queries and nv == 601 and m == 256
            and rows == {"a_query": 1024, "h_query": m})


def test_port_proves_with_reference_deserialized_keys(keys):
    shape, ref, params, pshape = keys
    assert _padded_layout(shape, ref)
    want = ref_groth16.create_proof_from_shape(ref, shape, R, S,
                                               qap=RefQap(shape, CURVE.fr, host_mode=True))
    proof = groth16.create_proof_from_shape(params, pshape, R, S)
    assert [_aff(proof.a), _aff(proof.b), _aff(proof.c)] == \
        [_aff(want.a), _aff(want.b), _aff(want.c)]
    pvk = groth16.prepare_verifying_key(params.curve, params.vk)
    publics = shape.input_assignment[1:]
    assert groth16.verify_proof(params.curve, pvk, proof, publics)
    assert not groth16.verify_proof(params.curve, pvk, proof, [(publics[0] + 1) % FR])


def test_nonzero_h_scalar_past_the_keys_rows_raises(keys, monkeypatch):
    _, _, params, pshape = keys
    rows = params.h_query[0].shape[0]
    witness_map = QapMatrices.witness_map

    def nonzero_past_cut(self, z_can, out_len):
        h = witness_map(self, z_can, out_len)
        assert out_len > rows and not bool(h[rows:].any())
        h[rows + 1, 0] = 1
        return h

    monkeypatch.setattr(QapMatrices, "witness_map", nonzero_past_cut)
    with pytest.raises(ValueError, match="nonzero"):
        groth16.create_proof_from_shape(params, pshape, R, S)

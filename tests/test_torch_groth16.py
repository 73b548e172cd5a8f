"""The port's Groth16 slice against the reference at m = 64: witness map,
setup queries and proofs, point for point, and the reference verifier's
verdicts, through the RCB MSM engine (the default) and the Jacobian one.
Tolerance: none."""

import contextlib

import numpy as np
import pytest
import torch
from test_torch_msm import reference_host_cutoff  # noqa: F401 (autouse)

from ckb_zkp_tpu.bench_circuits import product_circuit_shape, square_chain_shape
from ckb_zkp_tpu.host.pairing import get_curve
from ckb_zkp_tpu.ops.msm import device_group as ref_device_group
from ckb_zkp_tpu.schemes import groth16 as ref_groth16
from ckb_zkp_tpu.schemes.groth16.qap import QapMatrices as RefQap
from ckb_zkp_tpu_torch import bench_circuits as port_circuits
from ckb_zkp_tpu_torch.convert import params_from_reference
from ckb_zkp_tpu_torch.host.pairing import get_curve as port_curve
from ckb_zkp_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints
from ckb_zkp_tpu_torch.ops import ntt
from ckb_zkp_tpu_torch.ops.msm import device_group
from ckb_zkp_tpu_torch.schemes import groth16
from ckb_zkp_tpu_torch.schemes.groth16.qap import QapMatrices, qap_matrices

torch.set_num_threads(1)
CURVE = get_curve("bn254")
FR = CURVE.fr.modulus
TOXIC = (11, 12, 13, 14, 15)  # alpha, beta, gamma, delta, t


def _aff(p):
    return (True, None, None) if p.infinity else (False, p.x, p.y)


@pytest.fixture(scope="module")
def shape():
    return square_chain_shape(62, FR)


@pytest.fixture(scope="module")
def ref_params(shape):
    return ref_groth16.generate_parameters_from_shape(
        shape, CURVE, *TOXIC, host_mode=True)


@contextlib.contextmanager
def _jacobian_engine():
    """The port's cached CPU groups on the Jacobian engine, for the block."""
    groups = [device_group(port_curve("bn254"), g, "cpu") for g in ("g1", "g2")]
    for g in groups:
        g._use_rcb = False
    try:
        yield
    finally:
        for g in groups:
            g._use_rcb = True


def _port_setup():
    return groth16.generate_parameters_from_shape(
        port_circuits.square_chain_shape(62, FR), port_curve("bn254"), *TOXIC,
        device="cpu")


@pytest.fixture(scope="module")
def port_params(shape):
    return _port_setup()


@pytest.fixture(scope="module")
def port_params_jacobian(shape):
    with _jacobian_engine():
        return _port_setup()


@pytest.mark.parametrize("circuit", ["square_chain", "product"])
def test_witness_map_matches_host(circuit):
    shp = square_chain_shape(62, FR) if circuit == "square_chain" else \
        product_circuit_shape(20, FR)
    want = RefQap(shp, CURVE.fr, host_mode=True).witness_map_host(shp.full_assignment())
    q = QapMatrices(shp, CURVE.fr, "cpu")
    z = shp.full_assignment()
    z_can = torch.as_tensor(ints_to_limbs(z, 16).astype(np.int32))
    out_len = max(q.num_cols_pad, q.m)
    got = limbs_to_ints(q.witness_map(z_can, out_len))
    assert len(got) == out_len
    assert got[: q.m - 1] == want and not any(got[q.m - 1:])
    assert q.evaluations_at_host(7) == RefQap(shp, CURVE.fr, host_mode=True).evaluations_at_host(7)


def test_setup_matches_reference_host_mode(ref_params, port_params, shape):
    _check_setup(ref_params, port_params, shape)


def test_jacobian_setup_matches_reference_host_mode(ref_params, port_params_jacobian,
                                                     shape):
    """The same comparison for the Jacobian engine's setup (K9a fixed-base,
    queries padded to a power of two)."""
    _check_setup(ref_params, port_params_jacobian, shape)


def _check_setup(ref_params, port_params, shape):
    ni, na = shape.num_inputs, shape.num_aux
    assert port_params.padded_queries and not ref_params.padded_queries
    g1 = device_group(port_params.curve, "g1", "cpu")
    g2 = device_group(port_params.curve, "g2", "cpu")
    rg1 = ref_device_group(CURVE, "g1")
    rg2 = ref_device_group(CURVE, "g2")
    for name, dg, rdg, offset in (
        ("a_query", g1, rg1, 0), ("b_g1_query", g1, rg1, 0),
        ("b_g2_query", g2, rg2, 0), ("h_query", g1, rg1, 0),
        ("l_query", g1, rg1, ni),
    ):
        want = [_aff(p) for p in rdg.decode_points_host(getattr(ref_params, name))]
        got = [_aff(p) for p in dg.decode_points_host(getattr(port_params, name))]
        assert got[offset: offset + len(want)] == want, name
        pad = got[:offset] + got[offset + len(want):]
        assert all(p[0] for p in pad), f"{name}: padding rows must be infinity"
    assert len(port_params.l_query[0]) >= ni + na
    rvk, pvk = ref_params.vk, port_params.vk
    for k in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2"):
        assert _aff(getattr(pvk, k)) == _aff(getattr(rvk, k))
    assert [_aff(p) for p in pvk.gamma_abc_g1] == [_aff(p) for p in rvk.gamma_abc_g1]
    assert _aff(port_params.beta_g1) == _aff(ref_params.beta_g1)
    assert _aff(port_params.delta_g1) == _aff(ref_params.delta_g1)


def _ref_proof(ref_params, shape, r, s):
    return ref_groth16.create_proof_from_shape(
        ref_params, shape, r, s, qap=RefQap(shape, CURVE.fr, host_mode=True))


@pytest.mark.parametrize("key,r,s", [
    ("reference", 0, 0), ("reference", 3, 4), ("port", 3, 4), ("jacobian", 3, 4)])
def test_proof_matches_reference(ref_params, port_params, port_params_jacobian,
                                 shape, key, r, s):
    """With the reference's key carried across (exact, host-mode layout) the
    port's proof equals the reference's for the same (r, s); with the port's
    own setup (padded layout), whose queries equal the reference's (test
    above), it does too, on either MSM engine ("jacobian": the Jacobian
    engine's setup and prove)."""
    want = _ref_proof(ref_params, shape, r, s)
    params = {"reference": lambda: params_from_reference(ref_params, "cpu"),
              "port": lambda: port_params, "jacobian": lambda: port_params_jacobian}[key]()
    shp = port_circuits.square_chain_shape(62, FR)
    stages = {}
    engine = _jacobian_engine() if key == "jacobian" else contextlib.nullcontext()
    with engine:
        proof = groth16.create_proof_from_shape(params, shp, r, s, timings=stages)
    # the prover used (and kept) the shape's one QapMatrices
    q = qap_matrices(shp, params.curve.fr, "cpu")
    assert list(shp._torch_qap_cache.values()) == [q]
    assert q.device_parts()[1] is ntt.get_domain(params.curve.fr, q.m, "cpu")
    assert list(stages)[:3] == ["qap", "witness_limbs", "witness_map"]
    assert [_aff(proof.a), _aff(proof.b), _aff(proof.c)] == \
        [_aff(want.a), _aff(want.b), _aff(want.c)]
    curve = params.curve
    pvk = groth16.prepare_verifying_key(curve, params.vk)
    publics = shape.input_assignment[1:]
    assert groth16.verify_proof(curve, pvk, proof, publics)
    assert not groth16.verify_proof(curve, pvk, proof, [(publics[0] + 1) % FR])
    rpvk = ref_groth16.prepare_verifying_key(CURVE, ref_params.vk)
    assert ref_groth16.verify_proof(CURVE, rpvk, want, publics)


def test_repeated_witness_maps_reuse_device_tables():
    """The shape's matrices, the domain and its power tables are built once
    and kept (per shape, and per domain size), so a prover that keeps
    proving one circuit holds a fixed amount of device memory."""
    shp = port_circuits.square_chain_shape(62, FR)
    fr = port_curve("bn254").fr
    q = qap_matrices(shp, fr, "cpu")
    z_can = torch.as_tensor(ints_to_limbs(shp.full_assignment(), 16).astype(np.int32))
    first = q.witness_map(z_can, q.m)
    coos, dom = q.device_parts()
    tables = dict(dom._pows)
    domains = ntt._get_domain.cache_info().currsize
    assert torch.equal(q.witness_map(z_can, q.m), first)
    assert qap_matrices(shp, fr, "cpu") is q
    assert q.device_parts() == (coos, dom)
    assert dom is ntt.get_domain(fr, q.m, "cpu")
    assert ntt._get_domain.cache_info().currsize == domains
    assert len(tables) == 4 and dom._pows.keys() == tables.keys()
    assert all(dom._pows[k] is t for k, t in tables.items())

"""The port's device Groth16 setup against the JAX package on the CPU: the
Lagrange coefficients, the transpose sparse products, batch inversion, and
the whole setup (device branch and host mode), point for point. Inputs come
from numpy seeds; tolerance: none (canonical limbs, exact points)."""

import jax
import numpy as np
import pytest
import torch
from test_torch_msm import reference_host_cutoff  # noqa: F401 (autouse)

from ckb_zkp_tpu.bench_circuits import square_chain_shape
from ckb_zkp_tpu.host.pairing import get_curve
from ckb_zkp_tpu.ops.field import device_field as ref_device_field
from ckb_zkp_tpu.ops.msm import device_group as ref_device_group
from ckb_zkp_tpu.ops.ntt import get_domain as ref_get_domain
from ckb_zkp_tpu.ops.sparse import DeviceCoo as RefCoo
from ckb_zkp_tpu.r1cs import system as ref_system
from ckb_zkp_tpu.schemes import groth16 as ref_groth16
from ckb_zkp_tpu.schemes.groth16.qap import QapMatrices as RefQap
from ckb_zkp_tpu_torch import bench_circuits as port_circuits
from ckb_zkp_tpu_torch.host.pairing import get_curve as port_curve
from ckb_zkp_tpu_torch.ops.field import DeviceField
from ckb_zkp_tpu_torch.ops.limbs import to_numpy
from ckb_zkp_tpu_torch.ops.msm import device_group
from ckb_zkp_tpu_torch.ops.ntt import get_domain
from ckb_zkp_tpu_torch.ops.scan_utils import SegmentLayout, segment_sum
from ckb_zkp_tpu_torch.ops.sparse import DeviceCoo
from ckb_zkp_tpu_torch.r1cs import system as port_system
from ckb_zkp_tpu_torch.schemes import groth16
from ckb_zkp_tpu_torch.schemes.groth16.qap import QapMatrices, qap_matrices

torch.set_num_threads(1)
CURVE = get_curve("bn254")
FR = CURVE.fr.modulus
TOXIC = (21, 22, 23, 24, 25)  # alpha, beta, gamma, delta, t
QUERIES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")


def _np(a):
    return np.asarray(jax.device_get(a))


def _aff(p):
    return (True, None, None) if p.infinity else (False, p.x, p.y)


def _scalars(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64)
    return [sum(int(w) << (64 * j) for j, w in enumerate(row)) % FR for row in words]


@pytest.mark.parametrize("n,where", [(64, "outside"), (1024, "outside"),
                                     (64, "inside"), (1024, "inside")])
def test_lagrange_coefficients_match_reference(n, where):
    dom = get_domain(CURVE.fr, n, "cpu")
    tau = pow(dom.omega, 5, FR) if where == "inside" else _scalars(1, n)[0]
    got = dom.evaluate_all_lagrange_coefficients(tau)
    want = ref_get_domain(CURVE.fr, n).evaluate_all_lagrange_coefficients(tau)
    assert got.shape == (n, 16)
    assert np.array_equal(to_numpy(got), _np(want))
    vals = dom.df.decode(got)
    if where == "inside":
        assert vals == [int(i == 5) for i in range(n)]
    else:  # sum_i L_i(tau) = 1
        assert sum(vals) % FR == 1
    assert dom.evaluate_vanishing_polynomial(tau) == \
        ref_get_domain(CURVE.fr, n).evaluate_vanishing_polynomial(tau)


def test_batch_inv_with_zeros():
    fr = DeviceField(CURVE.fr, "cpu")
    xs = _scalars(100, 3)
    for i in (0, 7, 99):
        xs[i] = 0
    xs[1] = 1
    got = fr.batch_inv(fr.encode(xs))
    ref = ref_device_field(CURVE.fr)
    assert np.array_equal(to_numpy(got), _np(ref.batch_inv(ref.encode(xs))))
    assert fr.decode(got) == [pow(x, -1, FR) if x else 0 for x in xs]
    assert fr.decode(fr.powers(xs[2], 13)) == [pow(xs[2], i, FR) for i in range(13)]


@pytest.mark.parametrize("circuit", ["square_chain", "random"])
def test_rmatvec_padded_matches_reference(circuit):
    """A, B and C of a square chain (the setup's matrices, against the
    reference's device QapMatrices), and a random matrix with non-unit
    coefficients, repeated entries and long columns (against its DeviceCoo)."""
    fr = DeviceField(CURVE.fr, "cpu")
    if circuit == "square_chain":
        shp = square_chain_shape(62, FR)
        ref = RefQap(shp, CURVE.fr, host_mode=False)
        q = QapMatrices(port_circuits.square_chain_shape(62, FR), CURVE.fr, "cpu")
        (a, b, c), dom = q.device_parts()
        lag = dom.evaluate_all_lagrange_coefficients(TOXIC[-1])
        rlag = ref.domain.evaluate_all_lagrange_coefficients(TOXIC[-1])
        pairs = [(a, ref.a), (b, ref.b), (c, ref.c)]
    else:
        rng = np.random.default_rng(5)
        nr, nc, nnz = 48, 40, 300
        rows = rng.integers(0, nr, nnz).astype(np.int32)
        cols = np.minimum(rng.geometric(0.1, nnz) - 1, nc - 1).astype(np.int32)
        coeffs = _scalars(nnz, 6)
        coeffs[:5] = [1, 0, FR - 1, 2, 1]
        zs = _scalars(nr, 7)
        lag, rlag = fr.encode(zs), ref_device_field(CURVE.fr).encode(zs)
        pairs = [(DeviceCoo(fr, rows, cols, coeffs, nr, nc),
                  RefCoo(ref_device_field(CURVE.fr), rows, cols, coeffs, nr, nc))]
    for port, reference in pairs:
        got = port.rmatvec_padded(lag)
        assert got.shape == (reference.num_cols_pad, 16)
        assert np.array_equal(to_numpy(got), _np(reference.rmatvec_padded(rlag)))
        assert torch.equal(port.rmatvec(lag), got[: port.num_cols])
    if circuit == "random":
        want = [0] * nc
        for r, cc, k in zip(rows, cols, coeffs):
            want[cc] = (want[cc] + k * zs[r]) % FR
        assert fr.decode(port.rmatvec(lag)) == want


@pytest.mark.parametrize("spread", ["one_long", "geometric", "singletons"])
def test_segment_sum_blocks_grow_with_entries(spread):
    """The segment sum's blocks hold at most twice the entries, whatever the
    longest segment, and its sums are exact (small values: plain int sums)."""
    rng = np.random.default_rng(11)
    nseg, nnz = 1 << 12, 1 << 13
    if spread == "one_long":  # one segment holds half the entries
        seg = np.concatenate([np.full(nnz // 2, 7), rng.integers(0, nseg, nnz // 2)])
    elif spread == "geometric":
        seg = np.minimum(rng.geometric(0.002, nnz) - 1, nseg - 1)
    else:
        seg = rng.permutation(nseg)[: nnz // 4]
    seg = rng.permutation(seg)
    layout = SegmentLayout(seg, nseg, "cpu")
    assert layout.block_rows <= 2 * seg.size
    vals = rng.integers(0, 1 << 20, seg.size)
    fr = DeviceField(CURVE.fr, "cpu")
    got = fr.decode(segment_sum(fr, fr.encode(vals[layout.order].tolist()), layout))
    assert got == np.bincount(seg, weights=vals, minlength=nseg).astype(np.int64).tolist()


def _bits_shape(system, n: int, seed: int = 4):
    """n bits b_i with b_i * (ONE - b_i) = 0 and a public x = sum b_i 2^i
    bound by x * ONE = sum: ONE is in every row of B, and the last row of
    C holds n entries (the long column and row of a real R1CS)."""
    bits = [int(b) for b in np.random.default_rng(seed).integers(0, 2, n)]
    i = np.arange(n, dtype=np.int32)
    cols = 2 + i
    a = system.CooMatrix(np.append(i, n).astype(np.int32),
                         np.append(cols, 1).astype(np.int32), [1] * (n + 1))
    b = system.CooMatrix(np.append(np.repeat(i, 2), n).astype(np.int32),
                         np.append(np.stack([0 * i, cols], 1).ravel(), 0).astype(np.int32),
                         [1, FR - 1] * n + [1])
    c = system.CooMatrix(np.full(n, n, np.int32), cols, [1 << k for k in range(n)])
    x = sum(v << k for k, v in enumerate(bits))
    return system.R1csShape(num_inputs=2, num_aux=n, num_constraints=n + 1, a=a,
                            b=b, c=c, p=FR, input_assignment=[1, x],
                            aux_assignment=bits)


def test_setup_with_a_long_column_matches_reference():
    n = 40
    shp = _bits_shape(port_system, n)
    (a, b, c), _ = qap_matrices(shp, CURVE.fr, "cpu").device_parts()
    for mat in (a, b, c):
        for view in (mat._rows, mat.cols_view):
            assert view.layout.block_rows <= 2 * mat.nnz
    ref = ref_groth16.generate_parameters_from_shape(
        _bits_shape(ref_system, n), CURVE, *TOXIC, host_mode=False)
    port = groth16.generate_parameters_from_shape(
        shp, port_curve("bn254"), *TOXIC, device="cpu")
    _same_keys(port, ref, exact_len=True)
    curve = port.curve
    proof = groth16.create_proof_from_shape(port, shp, 3, 4)
    pvk = groth16.prepare_verifying_key(curve, port.vk)
    x = shp.input_assignment[1]
    assert groth16.verify_proof(curve, pvk, proof, [x])
    assert not groth16.verify_proof(curve, pvk, proof, [x + 1])


def test_device_instance_map_matches_host():
    shp = port_circuits.product_circuit_shape(20, FR)
    q = QapMatrices(shp, CURVE.fr, "cpu")
    fr = q.df
    for t in (TOXIC[-1], pow(CURVE.fr.root_of_unity(q.m), 3, FR)):
        got = q.evaluations_at(t)
        assert all(x.shape == (q.num_cols_pad, 16) for x in got)
        nv = q.num_variables
        assert tuple(fr.decode(x[:nv]) for x in got) == q.evaluations_at_host(t)
        assert all(not x[nv:].any() for x in got)
    with pytest.raises(ValueError, match="host-mode"):
        QapMatrices(shp, CURVE.fr, "cpu", host_mode=True).device_parts()


@pytest.fixture(scope="module", params=[64, 128])
def setups(request):
    m = request.param
    n = m - 2
    ref = ref_groth16.generate_parameters_from_shape(
        square_chain_shape(n, FR), CURVE, *TOXIC, host_mode=False)
    timings = {}
    port = groth16.generate_parameters_from_shape(
        port_circuits.square_chain_shape(n, FR), port_curve("bn254"), *TOXIC,
        device="cpu", timings=timings)
    return m, ref, port, timings


def _same_keys(port, ref, exact_len):
    for name in QUERIES:
        group = "g2" if name == "b_g2_query" else "g1"
        want = ref_device_group(CURVE, group).decode_points_host(getattr(ref, name))
        got = device_group(port.curve, group, "cpu").decode_points_host(getattr(port, name))
        if exact_len:
            assert len(got) == len(want), name
        assert [_aff(p) for p in got] == [_aff(p) for p in want], name
    rvk, pvk = ref.vk, port.vk
    for k in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2"):
        assert _aff(getattr(pvk, k)) == _aff(getattr(rvk, k))
    assert [_aff(p) for p in pvk.gamma_abc_g1] == [_aff(p) for p in rvk.gamma_abc_g1]
    assert _aff(port.beta_g1) == _aff(ref.beta_g1)
    assert _aff(port.delta_g1) == _aff(ref.delta_g1)
    assert (port.domain_size, port.num_inputs, port.num_aux, port.num_constraints) == \
        (ref.domain_size, ref.num_inputs, ref.num_aux, ref.num_constraints)


def test_device_setup_matches_reference_device_branch(setups):
    m, ref, port, timings = setups
    assert port.padded_queries and ref.padded_queries and port.domain_size == m
    _same_keys(port, ref, exact_len=True)
    assert list(timings) == ["lagrange", "rmatvec", "setup_scalars", "window_tables",
                             "fixed_base_g1", "fixed_base_g2", "verifying_key"]


def test_device_setup_proves_and_verifies(setups):
    m, _, port, _ = setups
    shp = port_circuits.square_chain_shape(m - 2, FR)
    curve = port.curve
    proof = groth16.create_proof_from_shape(port, shp, 3, 4)
    pvk = groth16.prepare_verifying_key(curve, port.vk)
    publics = shp.input_assignment[1:]
    assert groth16.verify_proof(curve, pvk, proof, publics)
    assert not groth16.verify_proof(curve, pvk, proof, [(publics[0] + 1) % FR])


def test_host_mode_setup_matches_reference_host_mode():
    ref = ref_groth16.generate_parameters_from_shape(
        square_chain_shape(62, FR), CURVE, *TOXIC, host_mode=True)
    timings = {}
    port = groth16.generate_parameters_from_shape(
        port_circuits.square_chain_shape(62, FR), port_curve("bn254"), *TOXIC,
        device="cpu", timings=timings, host_mode=True)
    assert not port.padded_queries and not ref.padded_queries
    assert len(port.h_query[0]) == 63 and len(port.l_query[0]) == port.num_aux
    _same_keys(port, ref, exact_len=True)
    assert list(timings)[0] == "instance_map"

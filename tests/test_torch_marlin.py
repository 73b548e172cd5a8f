"""The port's polynomial layer and Marlin on the CPU, against the JAX
package.

`ops/poly.py`: `poly_divide_linear` at z = 0, 1, p - 1 and a random z for
n = 1, 2, 7 and 2^12 against the JAX package's `ops/poly` and the host
long division; `poly_mul` and the AHP's two device products against
`hpoly.mul`, `poly_eval` against `hpoly.evaluate`, with trailing zero
coefficients, and `poly_add`, `poly_sub`, `poly_scale` against theirs.
`ops/hdomain.py`: the four transforms at 2^10 in the port's
device branch against the JAX package's `HDomain` forced to host ints.
Marlin: the Mini circuit on BN254 as `tests/test_marlin.py` drives the JAX
package (`random.Random(123)`, SRS degree 128), the port indexing and
proving over the JAX package's SRS (`convert.srs_from_reference`): the
verifying key bytes and the proof (commitments, evaluations, openings)
equal the JAX package's, the proof verifies in both verifiers and a wrong
public input is refused; the native C++ Marlin verifier on the port's
cells gives the JAX package's codes. The port's own setup and the device branch of
`HDomain` inside the AHP are `tests/test_torch_marlin_setup.py`.
Tolerance: none (integers and points are exact). JAX runs eagerly."""

import random

import pytest
import torch
from test_torch_msm import reference_host_cutoff  # noqa: F401 (autouse)

from ckb_zkp_tpu.circuits import Mini as RefMini
from ckb_zkp_tpu.host import poly as ref_hpoly
from ckb_zkp_tpu.host.curves import AffinePoint as RefPoint
from ckb_zkp_tpu.host.pairing import get_curve as ref_curve
from ckb_zkp_tpu.ops import poly as ref_poly
from ckb_zkp_tpu.ops.field import device_field as ref_device_field
from ckb_zkp_tpu.ops.hdomain import HDomain as RefHDomain
from ckb_zkp_tpu.schemes import kzg10 as ref_kzg10
from ckb_zkp_tpu.schemes import marlin as ref_marlin
from ckb_zkp_tpu.schemes.marlin import pc as ref_pc
from ckb_zkp_tpu_torch.circuits import Mini
from ckb_zkp_tpu_torch.convert import srs_from_reference
from ckb_zkp_tpu_torch.host.pairing import get_curve
from ckb_zkp_tpu_torch.ops import poly
from ckb_zkp_tpu_torch.ops.field import device_field
from ckb_zkp_tpu_torch.ops.hdomain import HDomain
from ckb_zkp_tpu_torch.schemes import marlin
from ckb_zkp_tpu_torch.schemes.marlin import ahp

torch.set_num_threads(1)
CURVE = get_curve("bn254")
P = CURVE.fr.modulus
DF = device_field(CURVE.fr, "cpu")
REF_DF = ref_device_field(ref_curve("bn254").fr)


def _rand(rng, n):
    return [rng.randrange(P) for _ in range(n)]


@pytest.mark.parametrize("n", [1, 2, 7, 1 << 12])
def test_divide_linear_equals_the_reference(n):
    rng = random.Random(n)
    coeffs = _rand(rng, n)
    ref_enc = REF_DF.encode(coeffs)
    for z in (0, 1, P - 1, _rand(rng, 1)[0]):
        q, r = poly.poly_divide_linear(DF, DF.encode(coeffs), z)
        rq, rr = ref_poly.poly_divide_linear(REF_DF, ref_enc, z)
        got = (DF.decode(q), DF.decode_scalar(r))
        assert got == (REF_DF.decode(rq), REF_DF.decode_scalar(rr)), z
        hq, hr = ref_hpoly.divmod_poly(coeffs, [(-z) % P, 1], P)
        assert ref_hpoly.trim(got[0]) == hq and [got[1]] == hr, z
        assert got[1] == ref_hpoly.evaluate(coeffs, z, P)


def test_divide_linear_rounds_are_logarithmic(monkeypatch):
    """One product by z^d a round: ceil(log2 n) K1 calls, not one a
    coefficient."""
    calls = []
    mul = DF.mul
    monkeypatch.setattr(DF, "mul", lambda a, b: calls.append(a.shape) or mul(a, b))
    poly.poly_divide_linear(DF, DF.encode(list(range(1000))), 5)
    assert len(calls) == 10


@pytest.mark.parametrize("na,nb,zeros", [(7, 5, 0), (1, 9, 0), (33, 17, 3), (300, 2, 5)])
def test_mul_and_eval_equal_the_host(na, nb, zeros):
    rng = random.Random(na)
    a = _rand(rng, na) + [0] * zeros  # trailing zero coefficients
    b = _rand(rng, nb)
    want = ref_hpoly.mul(a, b, P)
    got = DF.decode(poly.poly_mul(DF, DF.encode(a), DF.encode(b)))
    assert ref_hpoly.trim(got) == want and len(got) == na + zeros + nb - 1
    assert ahp._poly_mul(CURVE.fr, a, b + [0] * zeros, "cpu") == want
    x = _rand(rng, 1)[0]
    for c in (a, b):
        assert DF.decode_scalar(poly.poly_eval(DF, DF.encode(c), x)) == ref_hpoly.evaluate(c, x, P)
    ea, eb = DF.encode(a), DF.encode(b)
    assert ref_hpoly.trim(DF.decode(poly.poly_add(DF, ea, eb))) == ref_hpoly.add(a, b, P)
    assert ref_hpoly.trim(DF.decode(poly.poly_sub(DF, ea, eb))) == ref_hpoly.sub(a, b, P)
    assert DF.decode(poly.poly_scale(DF, ea, x)) == ref_hpoly.scale(a, x, P)


def test_hdomain_device_branch_equals_the_reference_host_ints(monkeypatch):
    n = 1 << 10
    monkeypatch.setattr(RefHDomain, "HOST_SIZE", n)
    ref = RefHDomain(ref_curve("bn254").fr, n)
    port = HDomain(CURVE.fr, n, "cpu")
    assert ref._host_mode and not port._host_mode and port.omega == ref.omega
    rng = random.Random(10)
    xs = _rand(rng, n - 3)  # padded by the domain
    for name in ("fft", "ifft", "coset_fft", "coset_ifft"):
        assert getattr(port, name)(xs) == getattr(ref, name)(xs), name
    assert port.diagonal_evals() == ref.diagonal_evals()
    assert port.batch_evals(12345) == ref.batch_evals(12345)


# ------------------------------------------------------------- Marlin Mini
def _pt(p):
    return (True,) if p.infinity else (False, p.x, p.y)


def _comm(c):
    return (_pt(c.comm), None if c.shifted_comm is None else _pt(c.shifted_comm))


def proof_fields(proof):
    return ([[_comm(c) for c in round_] for round_ in proof.commitments],
            list(proof.evaluations),
            [(_pt(o.w), o.rand_v) for o in proof.opening_proofs])


def ref_proof_of(proof):
    """The port's proof as the JAX package's classes."""
    pt = lambda p: RefPoint(p.x, p.y, p.infinity)  # noqa: E731
    comm = lambda c: ref_pc.Commitment(  # noqa: E731
        pt(c.comm), None if c.shifted_comm is None else pt(c.shifted_comm))
    return ref_marlin.Proof(
        commitments=[[comm(c) for c in r] for r in proof.commitments],
        evaluations=list(proof.evaluations),
        opening_proofs=[ref_kzg10.OpenProof(pt(o.w), o.rand_v) for o in proof.opening_proofs])


def reference_mini():
    """The JAX package's Mini run (as tests/test_marlin.py) and the rng
    state after its setup."""
    curve = ref_curve("bn254")
    rng = random.Random(123)
    srs = ref_marlin.universal_setup(curve, 128, rng)
    state = rng.getstate()
    ipk, ivk = ref_marlin.index(srs, RefMini.power_off())
    proof = ref_marlin.create_random_proof(ipk, RefMini.power_on(2, 3, 10), rng)
    return {"srs": srs, "state": state, "ivk": ivk, "proof": proof}


def port_mini(srs, state):
    rng = random.Random()
    rng.setstate(state)
    ipk, ivk = marlin.index(srs, Mini.power_off())
    proof = marlin.create_random_proof(ipk, Mini.power_on(2, 3, 10), rng)
    return ivk, proof


def check_against_reference(ref, ivk, proof):
    assert ivk.to_bytes() == ref["ivk"].to_bytes()
    assert proof_fields(proof) == proof_fields(ref["proof"])
    assert marlin.verify_proof(ivk, proof, [10])
    assert not marlin.verify_proof(ivk, proof, [11])
    assert ref_marlin.verify_proof(ref["ivk"], ref_proof_of(proof), [10])


@pytest.fixture(scope="module")
def ref_run():
    return reference_mini()


@pytest.fixture(scope="module")
def port_run(ref_run):
    srs = srs_from_reference(ref_run["srs"], "cpu")
    assert srs.max_degree == ref_run["srs"].max_degree == 128
    return port_mini(srs, ref_run["state"])


def test_marlin_mini_over_the_reference_srs(ref_run, port_run):
    ivk, proof = port_run
    assert ivk.device == torch.device("cpu")
    check_against_reference(ref_run, ivk, proof)


def test_native_marlin_verifier_on_the_port_cells(port_run):
    """The native C++ Marlin verifier (`native/marlin_bn254.cc`, built by
    the port's `native`) on the port's Mini cells: 0, 2 and 1 as the JAX
    package's `test_native_marlin_verifier` expects, and the contract
    verifier's codes on the same cells. Skipped without g++, as that test."""
    from ckb_zkp_tpu_torch import contracts, native
    from ckb_zkp_tpu_torch.serialize.ark_schemes import ark_encode
    from ckb_zkp_tpu_torch.serialize.tobytes import fr_bytes

    if not native.available():
        pytest.skip("g++ unavailable")
    assert native.marlin_selftest() == 0
    ivk, proof = port_run
    vk_cell, proof_cell = ark_encode(CURVE, ivk), ark_encode(CURVE, proof)
    good, wrong = fr_bytes(CURVE, 10), fr_bytes(CURVE, 11)
    assert native.marlin_verify_bn254(vk_cell, proof_cell, good) == 0
    assert native.marlin_verify_bn254(vk_cell, proof_cell, wrong) == 2
    assert native.marlin_verify_bn254(vk_cell, proof_cell[:-3], good) == 1
    assert native.marlin_verify_bn254(vk_cell[:-9], proof_cell, good) == 1
    for cells in ((vk_cell, proof_cell, good), (vk_cell, proof_cell, wrong)):
        assert contracts.universal_marlin_verifier("bn254", *cells, device="cpu") == \
            native.marlin_verify_bn254(*cells)

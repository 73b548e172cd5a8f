"""The port's Bulletproofs on the CPU against the JAX package's.

- the inner-product argument at n = 4 and 16 over the JAX package's
  points: the same proof, which both verify, and a changed one refused;
- the Mini circuit's proof on BN254 and curve25519 from the same rng
  (`random.Random(77)`, as `tests/test_bulletproofs.py` seeds it): the
  port's `Generators`, dense R1CS and `Proof` and their ark bytes equal
  the JAX package's; the port verifies the JAX proof over the generators
  `convert` carries across, the JAX package verifies the port's, and a
  changed public input is refused;
- the device paths (FIXED_BASE_MSM_MIN patched to 8 on BN254): the
  generators (K6's fixed-base MSM), the commitments' rows, IPP_P and the
  IPA's first round run `msm_many` on the port's device group and give
  the host path's proof;
- the dense-matrix codec against the JAX package's generic walk (bytes,
  values, and errors on cut and corrupted bytes);
- `mini_bulletproofs_verifier` gives the JAX entry point's OK, ERR_VERIFY
  and ERR_ENCODING on JAX-made cells, and a RuntimeError raised inside
  the verifier is no verdict.

Tolerance: none (bytes and field values are exact). The JAX package runs
its host paths only."""

import random

import pytest
import torch

from ckb_zkp_tpu import contracts as ref_contracts
from ckb_zkp_tpu.circuits import Mini as RefMini
from ckb_zkp_tpu.host.pairing import get_curve as ref_curve
from ckb_zkp_tpu.host.ristretto import Curve25519 as RefCurve25519
from ckb_zkp_tpu.schemes import bulletproofs as ref_bp
from ckb_zkp_tpu.schemes.bulletproofs import inner_product_proof as ref_ipp
from ckb_zkp_tpu.schemes.bulletproofs.common import inner_product
from ckb_zkp_tpu.serialize import ark_schemes as ref_ark
from ckb_zkp_tpu.serialize.tobytes import fr_bytes
from ckb_zkp_tpu.transcript import Transcript as RefTranscript
from ckb_zkp_tpu_torch import contracts, convert
from ckb_zkp_tpu_torch.circuits import Mini
from ckb_zkp_tpu_torch.host.pairing import get_curve
from ckb_zkp_tpu_torch.host.ristretto import Curve25519
from ckb_zkp_tpu_torch.ops import msm
from ckb_zkp_tpu_torch.schemes import bulletproofs as bp
from ckb_zkp_tpu_torch.schemes.bulletproofs import inner_product_proof as ipp
from ckb_zkp_tpu_torch.serialize import ark_schemes
from ckb_zkp_tpu_torch.serialize.ark_schemes import S, Tup, ark_decode, ark_encode
from ckb_zkp_tpu_torch.transcript import Transcript

torch.set_num_threads(1)
CURVES = {"bn254": (get_curve("bn254"), ref_curve("bn254")),
          "curve25519": (Curve25519(), RefCurve25519())}
CELL = (S(bp.Generators), S(bp.R1csCircuit), S(bp.Proof))
REF_CELL = (ref_ark.S(ref_bp.Generators), ref_ark.S(ref_bp.R1csCircuit),
            ref_ark.S(ref_bp.Proof))


@pytest.mark.parametrize("n", [4, 16])
def test_ipa_equals_jax(n):
    curve, rcurve = CURVES["bn254"]
    p = curve.fr.modulus
    rng = random.Random(n)
    rg = rcurve.g1
    gpt = lambda: rg.mul(rcurve.g1_gen, rng.randrange(1, p))  # noqa: E731
    g_vec = [gpt() for _ in range(n)]
    h_vec = [gpt() for _ in range(n)]
    u = gpt()
    a = [rng.randrange(p) for _ in range(n)]
    b = [rng.randrange(p) for _ in range(n)]
    P = rg.add(rg.add(rg.msm(g_vec, a), rg.msm(h_vec, b)), rg.mul(u, inner_product(a, b, p)))
    want = ref_ipp.prove(rcurve, RefTranscript(b"test"), list(g_vec), list(h_vec), u, P, a, b)

    pt = convert.point_from_reference
    g_vec, h_vec, u, P = [pt(q) for q in g_vec], [pt(q) for q in h_vec], pt(u), pt(P)
    got = ipp.prove(curve, Transcript(b"test"), list(g_vec), list(h_vec), u, P, a, b,
                    device="cpu")
    assert ark_encode(curve, got) == ref_ark.ark_encode(rcurve, want)
    assert ipp.verify(curve, Transcript(b"test"), list(g_vec), list(h_vec), u, P, got)
    bad = ipp.Proof(got.L_vec, got.R_vec, got.a, (got.b + 1) % p)
    assert not ipp.verify(curve, Transcript(b"test"), list(g_vec), list(h_vec), u, P, bad)


@pytest.fixture(scope="module")
def mini_runs():
    """Per curve: the JAX package's and the port's (host path) Mini
    (gens, r1cs, proof), both from `random.Random(77)`."""
    out = {}
    for name, (curve, rcurve) in CURVES.items():
        want = ref_bp.create_random_proof(rcurve, RefMini.power_on(2, 3, 10), random.Random(77))
        got = bp.create_random_proof(curve, Mini.power_on(2, 3, 10), random.Random(77),
                                     device="cpu")
        out[name] = (want, got)
    return out


@pytest.mark.parametrize("name", ["bn254", "curve25519"])
def test_mini_proof_bytes_equal_jax(mini_runs, name):
    curve, rcurve = CURVES[name]
    (rgens, rr1cs, rproof), (gens, r1cs, proof) = mini_runs[name]
    assert (gens.n, gens.N, gens.k, gens.n_w) == (10, 16, 2, 2)
    cell = ark_encode(curve, (gens, r1cs, proof), Tup(*CELL))
    want = ref_ark.ark_encode(rcurve, (rgens, rr1cs, rproof), ref_ark.Tup(*REF_CELL))
    assert cell == want
    assert ark_encode(curve, convert.bulletproofs_generators_from_reference(rgens)) == \
        ref_ark.ark_encode(rcurve, rgens)
    assert ark_encode(curve, ark_decode(curve, cell, Tup(*CELL), device="cpu"),
                      Tup(*CELL)) == cell

    # each verifier on the other package's proof, and a changed input refused
    from_ref = ark_decode(curve, ref_ark.ark_encode(rcurve, rproof), bp.Proof)
    ref_gens = convert.bulletproofs_generators_from_reference(rgens)
    assert bp.verify_proof(curve, ref_gens, from_ref, r1cs, [10]) is True
    assert bp.verify_proof(curve, gens, proof, r1cs, [11]) is False
    from_port = ref_ark.ark_decode(rcurve, ark_encode(curve, proof), ref_bp.Proof)
    assert ref_bp.verify_proof(rcurve, rgens, from_port, rr1cs, [10]) is True


def test_device_paths_give_the_host_proof(mini_runs, monkeypatch):
    """BN254 Mini (n = 10 constraints, N = 16) with FIXED_BASE_MSM_MIN at
    8: the 35 generators are one fixed-base MSM, the commitments' rows of
    10 scalars over g_vec_N (aL, aO, sL) and h_vec_N (aR, sR) two
    `msm_many` calls, IPP_P's l_x and r_x two more, and the IPA's first
    round (n = 8) four: the proof equals the host path's."""
    curve, _ = CURVES["bn254"]
    monkeypatch.setattr(msm, "FIXED_BASE_MSM_MIN", 8)
    calls, fixed = [], []
    real_many, real_fixed = msm.DeviceCurveGroup.msm_many, msm.DeviceCurveGroup.fixed_base_msm
    monkeypatch.setattr(msm.DeviceCurveGroup, "msm_many", lambda self, jobs: (
        calls.append([int(s.shape[0]) for _, s in jobs]) or real_many(self, jobs)))
    monkeypatch.setattr(msm.DeviceCurveGroup, "fixed_base_msm", lambda self, t, s, *a: (
        fixed.append(int(s.shape[0])) or real_fixed(self, t, s, *a)))
    gens, r1cs, proof = bp.create_random_proof(curve, Mini.power_on(2, 3, 10),
                                               random.Random(77), device="cpu")
    assert fixed == [35]
    assert calls == [[10, 10, 10], [10, 10], [16], [16], [8], [8], [8], [8]]
    _, (hgens, hr1cs, hproof) = mini_runs["bn254"]
    assert ark_encode(curve, (gens, r1cs, proof), Tup(*CELL)) == \
        ark_encode(curve, (hgens, hr1cs, hproof), Tup(*CELL))


def _outcome(fn):
    try:
        return fn()
    except (ValueError, EOFError, IndexError) as e:
        return type(e)


def test_dense_codec_equals_the_jax_walk():
    """`DENSE` (the R1CS rows) in one pass: the generic walk's bytes and
    values (0, 1, p - 1, an empty row), and its results on cut bytes, a
    non-canonical element before a cut and one after a short row."""
    curve, rcurve = CURVES["bn254"]
    p = curve.fr.modulus
    spec = ark_schemes.DENSE
    value = [[0, 1, p - 1, 0], [], [5, 0, 0, 0], [0, 0, 0, 7]]
    data = ref_ark.ark_encode(rcurve, value, spec)
    assert ark_encode(curve, value, spec) == data
    assert ark_decode(curve, data, spec) == value
    high = b"\xff" * 32
    corrupt = [data[:16] + high + data[48:],  # row 0, element 0
               data[:16 + 64] + high + data[16 + 96:],  # row 0, element 2
               data[:16 + 64] + high + data[16 + 96: 16 + 112]]  # then cut
    for bad in corrupt + [data[:k] for k in (3, 12, 20, 47, 49, 150, 160, len(data) - 1)]:
        want = _outcome(lambda: ref_ark.ark_decode(rcurve, bad, spec))
        got = _outcome(lambda: ark_decode(curve, bad, spec))
        if isinstance(want, type):
            assert got is want
        else:
            assert ark_encode(curve, got, spec) == ref_ark.ark_encode(rcurve, want, spec)


def _frs(rcurve, xs):
    return b"".join(fr_bytes(rcurve, x) for x in xs)


def test_contract_verifier_gives_the_jax_codes(monkeypatch):
    _, rcurve = CURVES["bn254"]
    gens, r1cs, proof = ref_bp.create_random_proof(rcurve, RefMini.power_on(2, 3, 10),
                                                   random.Random(7))
    cell = ref_ark.ark_encode(rcurve, (gens, r1cs, proof), ref_ark.Tup(*REF_CELL))
    cases = [(b"", cell, _frs(rcurve, [10])), (b"", cell, _frs(rcurve, [11])),
             (b"", cell[:-4], _frs(rcurve, [10])), (b"", cell, b"\x01\x02")]
    codes = [contracts.mini_bulletproofs_verifier("bn254", *c, device="cpu") for c in cases]
    assert codes == [ref_contracts.mini_bulletproofs_verifier("bn254", *c) for c in cases]
    assert codes == [contracts.OK, contracts.ERR_VERIFY, contracts.ERR_ENCODING,
                     contracts.ERR_ENCODING]

    def launch_failed(*a, **kw):
        raise RuntimeError("zkp_mont_mul: CUDA error 700")

    monkeypatch.setattr(bp.arithmetic_circuit, "verify_proof", launch_failed)
    with pytest.raises(RuntimeError):
        contracts.mini_bulletproofs_verifier("bn254", *cases[0], device="cpu")

"""The port's contract verifiers (`ckb_zkp_tpu_torch/contracts.py`) on the
CPU, against the JAX package's, as `tests/test_contracts.py:19-92` drives
them: Groth16 (Mini, BN254, `random.Random(3)`), Marlin (Mini, BN254,
`random.Random(123)`, SRS 128) and PLONK (`tests/test_plonk.py`'s
reference circuit, BN254, `random.Random(21)`, SRS 64).

Each cell, made by the JAX package, gives the port's entry point the code
the JAX entry point gives: OK, ERR_VERIFY on a changed public input,
ERR_ENCODING on a cut proof or publics cell. The Marlin ivk and proof
bytes decoded by the port's `ark_decode` re-encode to the same bytes. A
RuntimeError inside a verifier (what a failed CUDA launch raises) is no
verdict: it propagates. The port's own PLONK bytes equal the JAX
package's (`tests/test_torch_plonk.py`), so the cells are the JAX
package's: a port prove from the plain versions takes a minute (Marlin)
or half of one (PLONK). Tolerance: none (codes and bytes are exact). JAX
runs eagerly."""

import random

import pytest
import torch
from test_torch_marlin import reference_mini
from test_torch_msm import reference_host_cutoff  # noqa: F401 (autouse)
from test_torch_plonk import reference_circuit

from ckb_zkp_tpu import contracts as ref_contracts
from ckb_zkp_tpu.circuits import Mini as RefMini
from ckb_zkp_tpu.host.pairing import get_curve as ref_curve
from ckb_zkp_tpu.schemes import groth16 as ref_groth16
from ckb_zkp_tpu.schemes.groth16 import serialize as ref_g16ser
from ckb_zkp_tpu.schemes.plonk import Composer as RefComposer
from ckb_zkp_tpu.schemes.plonk import Plonk as RefPlonk
from ckb_zkp_tpu.schemes.plonk import serialize as ref_pser
from ckb_zkp_tpu.serialize import ark_schemes as ref_ark
from ckb_zkp_tpu.serialize.tobytes import fr_bytes
from ckb_zkp_tpu_torch import contracts
from ckb_zkp_tpu_torch.host.pairing import get_curve
from ckb_zkp_tpu_torch.schemes.marlin import marlin
from ckb_zkp_tpu_torch.schemes.plonk import Composer, Plonk, default_ks
from ckb_zkp_tpu_torch.serialize.ark_schemes import FR, Vec, ark_decode, ark_encode

torch.set_num_threads(1)
CURVE = get_curve("bn254")
REF_CURVE = ref_curve("bn254")
P = CURVE.fr.modulus


def _frs(xs):
    return b"".join(fr_bytes(REF_CURVE, x) for x in xs)


def _plonk_publics(xs):
    return ref_ark.ark_encode(REF_CURVE, xs, ref_ark.Vec(ref_ark.FR))


@pytest.fixture(scope="module")
def cells():
    """The JAX package's cells of the three schemes."""
    rng = random.Random(3)
    params = ref_groth16.generate_random_parameters(RefMini.power_off(), REF_CURVE, rng)
    g16_proof = ref_groth16.create_proof_no_zk(params, RefMini.power_on(2, 3, 10))
    mini = reference_mini()
    rng = random.Random(21)
    cs = reference_circuit(RefComposer, P)
    srs = RefPlonk.setup(REF_CURVE, 64, rng)
    pk, vk = RefPlonk.keygen(REF_CURVE, srs, cs, default_ks(P))
    proof = RefPlonk.prove(REF_CURVE, pk, cs, rng)
    return {
        "groth16": (ref_g16ser.vk_to_bytes(REF_CURVE, params.vk),
                    ref_g16ser.proof_to_bytes(REF_CURVE, g16_proof), _frs([10])),
        "marlin": (ref_ark.ark_encode(REF_CURVE, mini["ivk"]),
                   ref_ark.ark_encode(REF_CURVE, mini["proof"]), _frs([10])),
        "plonk": (ref_pser.vk_to_bytes(REF_CURVE, vk), ref_pser.proof_to_bytes(REF_CURVE, proof),
                  _plonk_publics(cs.public_inputs())),
    }


def _variant(scheme, which, vk_cell, proof_cell, publics_cell):
    """The cells of one case of `tests/test_contracts.py`."""
    if which == "wrong_public":
        publics_cell = (_plonk_publics([1] + reference_circuit(Composer, P).public_inputs()[1:])
                        if scheme == "plonk" else _frs([11]))
    elif which == "cut_proof":
        proof_cell = proof_cell[:-5]
    elif which == "cut_publics":
        publics_cell = publics_cell[:-1]
    return vk_cell, proof_cell, publics_cell


CASES = {"ok": contracts.OK, "wrong_public": contracts.ERR_VERIFY,
         "cut_proof": contracts.ERR_ENCODING, "cut_publics": contracts.ERR_ENCODING}


@pytest.mark.parametrize("which", CASES)
@pytest.mark.parametrize("scheme", ["groth16", "marlin", "plonk"])
def test_cells_give_the_reference_codes(cells, scheme, which):
    args = _variant(scheme, which, *cells[scheme])
    ref_entry = getattr(ref_contracts, f"universal_{scheme}_verifier")
    entry = getattr(contracts, f"universal_{scheme}_verifier")
    kwargs = {} if scheme == "groth16" else {"device": "cpu"}
    got = entry("bn254", *args, **kwargs)
    assert got == ref_entry("bn254", *args) == CASES[which]


def test_codes_are_the_references():
    assert (contracts.OK, contracts.ERR_ENCODING, contracts.ERR_VERIFY) == (
        ref_contracts.OK, ref_contracts.ERR_ENCODING, ref_contracts.ERR_VERIFY) == (0, 1, 2)


def test_marlin_bytes_decode_and_reencode(cells):
    vk_cell, proof_cell, _ = cells["marlin"]
    ivk = ark_decode(CURVE, vk_cell, marlin.IndexVerifierKey, "cpu")
    proof = ark_decode(CURVE, proof_cell, marlin.Proof)
    assert ivk.device == "cpu" and ivk.curve is CURVE
    assert ark_encode(CURVE, ivk) == vk_cell
    assert ark_encode(CURVE, proof) == proof_cell
    assert marlin.verify_proof(ivk, proof, [10]) is True
    # the device is no part of the bytes
    assert ark_decode(CURVE, vk_cell, marlin.IndexVerifierKey).device == "cuda"


def test_plonk_publics_cell_is_a_vec_of_fr(cells):
    publics = reference_circuit(Composer, P).public_inputs()
    assert ark_encode(CURVE, publics, Vec(FR)) == cells["plonk"][2]


@pytest.mark.parametrize("scheme", ["marlin", "plonk"])
def test_a_runtime_error_is_no_verdict(monkeypatch, cells, scheme):
    def launch_failed(*args, **kwargs):
        raise RuntimeError("CUDA launch failed (cudaError_t 719)")

    if scheme == "marlin":
        monkeypatch.setattr(marlin, "verify_proof", launch_failed)
    else:
        monkeypatch.setattr(Plonk, "verify", launch_failed)
    entry = getattr(contracts, f"universal_{scheme}_verifier")
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        entry("bn254", *cells[scheme], device="cpu")

"""The port's Marlin universal setup, and the Mini proof over it with the
port's `HDomain` forced to its device branch, on the CPU, against the JAX
package.

`marlin.universal_setup` from the same `random.Random(123)` as
`tests/test_marlin.py` gives the JAX package's SRS limb for limb (the
power arrays after the repack of `convert.srs_from_reference`, and the
points); with `HDomain.HOST_SIZE` patched to 0, so that every transform
inside the AHP runs through the port's device NTT (`ops/ntt.py` over K1's
plain version here), the port indexes and proves Mini over that SRS: the
verifying key bytes and the proof equal the JAX package's, the proof
verifies in both verifiers and a wrong public input is refused. The CLI's
Marlin and PLONK setup file of that SRS (`_srs_to_portable` in ark bytes)
equals the JAX CLI's and reads back to the same powers. Tolerance: none.
JAX runs eagerly."""

import importlib
import random

import pytest
import torch
from test_torch_marlin import check_against_reference, port_mini, reference_mini
from test_torch_msm import reference_host_cutoff  # noqa: F401 (autouse)

from ckb_zkp_tpu.host.pairing import get_curve as ref_curve
from ckb_zkp_tpu.serialize import ark_schemes as ref_ark
from ckb_zkp_tpu_torch.convert import srs_from_reference
from ckb_zkp_tpu_torch.host.pairing import get_curve
from ckb_zkp_tpu_torch.ops.hdomain import HDomain
from ckb_zkp_tpu_torch.schemes import marlin
from ckb_zkp_tpu_torch.serialize.ark_schemes import ark_decode, ark_encode

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref():
    return reference_mini()


@pytest.fixture(scope="module")
def port_setup():
    """The port's SRS from `random.Random(123)`, and the rng's state after it."""
    rng = random.Random(123)
    srs = marlin.universal_setup(get_curve("bn254"), 128, rng, device="cpu")
    return srs, rng.getstate()


def test_marlin_mini_over_the_port_setup_on_the_device_branch(monkeypatch, ref, port_setup):
    srs, state = port_setup
    assert state == ref["state"]
    want = srs_from_reference(ref["srs"], "cpu")
    for name in ("powers_of_g", "powers_of_gamma_g"):
        got, exp = getattr(srs, name), getattr(want, name)
        assert all(torch.equal(a, b) for a, b in zip(got, exp)), name
        assert got[0].shape == (129, 16)
    assert (srs.g, srs.gamma_g, srs.h, srs.beta_h) == (want.g, want.gamma_g, want.h, want.beta_h)
    monkeypatch.setattr(HDomain, "HOST_SIZE", 0)
    sizes = []
    device = HDomain._device
    monkeypatch.setattr(HDomain, "_device",
                        lambda self, xs, fn: sizes.append(self.size) or device(self, xs, fn))
    ivk, proof = port_mini(srs, ref["state"])
    check_against_reference(ref, ivk, proof)
    # every transform of the index, the prover and the verifier ran there
    assert sorted(set(sizes)) == [2, 16, 32, 64, 128]


def test_setup_file_bytes_equal_the_reference_cli(ref, port_setup):
    ref_cli = importlib.import_module("ckb_zkp_tpu.cli.main")
    cli = importlib.import_module("ckb_zkp_tpu_torch.cli.main")
    curve, spec = get_curve("bn254"), cli._srs_spec()
    srs, _ = port_setup
    want = ref_ark.ark_encode(ref_curve("bn254"), ref_cli._srs_to_portable(ref["srs"]),
                              ref_cli._srs_spec())
    got = ark_encode(curve, cli._srs_to_portable(srs, "cpu"), spec)
    assert got == want
    back = cli._srs_from_portable(curve, ark_decode(curve, got, spec, "cpu"), "cpu")
    for name in ("powers_of_g", "powers_of_gamma_g"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(back, name), getattr(srs, name)))
    assert (back.g, back.gamma_g, back.h, back.beta_h) == (srs.g, srs.gamma_g, srs.h, srs.beta_h)

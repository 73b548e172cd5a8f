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
verifies in both verifiers and a wrong public input is refused. Tolerance:
none. JAX runs eagerly."""

import random

import torch
from test_torch_marlin import check_against_reference, port_mini, reference_mini

from ckb_zkp_tpu_torch.convert import srs_from_reference
from ckb_zkp_tpu_torch.host.pairing import get_curve
from ckb_zkp_tpu_torch.ops.hdomain import HDomain
from ckb_zkp_tpu_torch.schemes import marlin

torch.set_num_threads(1)


def test_marlin_mini_over_the_port_setup_on_the_device_branch(monkeypatch):
    ref = reference_mini()
    rng = random.Random(123)
    srs = marlin.universal_setup(get_curve("bn254"), 128, rng, device="cpu")
    assert rng.getstate() == ref["state"]
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

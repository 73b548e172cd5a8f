"""The port's KZG10 on BLS12-381 on the CPU, against the JAX package, as
`tests/test_kzg10.py` drives it: the SRS of degree 12 from
`random.Random(11)` limb for limb, then, without hiding and with a hiding
bound of 2, a commitment to 7 random coefficients (trimmed to degree 8),
its blinding, the opening at a random point and `check`'s verdicts on
the true and a wrong value, each equal to the JAX package's. Tolerance:
none. JAX runs eagerly."""

import random

import pytest
import torch

from ckb_zkp_tpu.host.pairing import get_curve as ref_curve
from ckb_zkp_tpu.ops.field import device_field as ref_device_field
from ckb_zkp_tpu.schemes import kzg10 as ref_kzg10
from ckb_zkp_tpu_torch.convert import srs_from_reference
from ckb_zkp_tpu_torch.host.pairing import get_curve
from ckb_zkp_tpu_torch.ops.field import device_field
from ckb_zkp_tpu_torch.schemes import kzg10

torch.set_num_threads(1)


def _pt(p):
    return (True,) if p.infinity else (False, p.x, p.y)


@pytest.fixture(scope="module")
def setups():
    ref_rng, rng = random.Random(11), random.Random(11)
    ref_pp = ref_kzg10.setup(ref_curve("bls12_381"), 12, ref_rng)
    pp = kzg10.setup(get_curve("bls12_381"), 12, rng, device="cpu")
    assert rng.getstate() == ref_rng.getstate()
    return ref_pp, pp, rng.getstate()


def test_setup_equals_the_reference(setups):
    ref_pp, pp, _ = setups
    want = srs_from_reference(ref_pp, "cpu")
    for name in ("powers_of_g", "powers_of_gamma_g"):
        got, exp = getattr(pp, name), getattr(want, name)
        assert all(torch.equal(a, b) for a, b in zip(got, exp)), name
        assert got[0].shape == (13, 24)
    assert (pp.g, pp.gamma_g, pp.h, pp.beta_h) == (want.g, want.gamma_g, want.h, want.beta_h)


@pytest.mark.parametrize("hiding", [None, 2])
def test_commit_open_check_equal_the_reference(setups, hiding):
    ref_pp, pp, state = setups
    p = pp.curve.fr.modulus
    draw = random.Random(2024)
    coeffs = [draw.randrange(p) for _ in range(7)]
    point = draw.randrange(p)
    value = sum(c * pow(point, i, p) for i, c in enumerate(coeffs)) % p
    out = []
    for mod, params, df in ((ref_kzg10, ref_pp, ref_device_field(ref_pp.curve.fr)),
                            (kzg10, pp, device_field(pp.curve.fr, "cpu"))):
        rng = random.Random()
        rng.setstate(state)
        ck, vk = mod.trim(params, 8)
        cdev = df.encode(coeffs)
        comm, rand = mod.commit(ck, cdev, hiding_bound=hiding, rng=rng)
        proof = mod.open_at(ck, cdev, point, rand)
        out.append((_pt(comm), rand.blinding, _pt(proof.w), proof.rand_v,
                    mod.check(vk, comm, point, value, proof),
                    mod.check(vk, comm, point, (value + 1) % p, proof)))
    assert out[1] == out[0]
    assert out[1][4:] == (True, False) and len(out[1][1]) == (0 if hiding is None else 3)

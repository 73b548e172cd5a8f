"""The port's Hyrax and Libra (plain and zk) on the CPU against the JAX
package's, over BLS12-381.

- Hyrax: the reference's test circuit (`tests/test_hyrax.py`: 4
  instances, `random.Random(42)`): the port's parameters, proof and
  outputs and their ark bytes equal the JAX package's; `convert` carries
  the JAX parameters across; the proof verifies and a changed output is
  refused. With `_use_device_tables` on (16 instances), the zk
  sumchecks' tables run on the port's `DeviceSumcheck` and give the host
  path's proof.
- Libra: the reference circuit (`tests/test_libra.py`): the plain proof
  equals the JAX package's, with the host tables and with every layer's
  `DeviceLayer`; the zk proof (`random.Random(88)`) and its parameters
  equal the JAX package's bytes, with the host tables and with the device
  layers; each verifies and a changed output is refused.
- The Libra and Hyrax contract verifiers give the JAX entry points' OK,
  ERR_VERIFY and ERR_ENCODING on JAX-made cells (the reference circuits,
  passed as `circuit=`).

Tolerance: none (bytes and field values are exact). The JAX package runs
its host paths only; the port's MSMs stay below FIXED_BASE_MSM_MIN (host)."""

import dataclasses
import random

import pytest
import torch

from ckb_zkp_tpu import contracts as ref_contracts
from ckb_zkp_tpu.host.pairing import get_curve as ref_curve
from ckb_zkp_tpu.schemes import hyrax as ref_hyrax
from ckb_zkp_tpu.schemes import libra as ref_libra
from ckb_zkp_tpu.serialize import ark_schemes as ref_ark
from ckb_zkp_tpu_torch import contracts, convert
from ckb_zkp_tpu_torch.host.pairing import get_curve
from ckb_zkp_tpu_torch.ops import sumcheck
from ckb_zkp_tpu_torch.schemes import hyrax, libra
from ckb_zkp_tpu_torch.schemes.hyrax import zk_sumcheck
from ckb_zkp_tpu_torch.schemes.libra import linear_gkr, zk_linear_gkr
from ckb_zkp_tpu_torch.serialize.ark_schemes import ark_encode

torch.set_num_threads(1)
CURVE, REF_CURVE = get_curve("bls12_381"), ref_curve("bls12_381")
P = CURVE.fr.modulus
LAYERS = [
    [(1, 0, 1), (0, 2, 3), (0, 4, 5), (1, 6, 7),
     (1, 15, 8), (1, 9, 10), (0, 11, 12), (0, 13, 14)],
    [(1, 0, 1), (0, 2, 3), (0, 4, 5), (1, 6, 7)],
    [(0, 0, 1), (0, 1, 2), (1, 2, 3), (1, 1, 3)],
]
INPUTS, WITNESSES = list(range(1, 9)), list(range(9, 17))


def _bad_first(outputs):
    """The outputs with the first element of the first one changed."""
    if isinstance(outputs[0], list):
        return [_bad_first(outputs[0])] + [list(o) for o in outputs[1:]]
    return [(outputs[0] + 1) % P] + list(outputs[1:])


def _device_rounds(monkeypatch, names):
    """Records each `DeviceSumcheck` round method of `names` that runs."""
    seen = []
    for name in names:
        real = getattr(sumcheck.DeviceSumcheck, name)
        monkeypatch.setattr(sumcheck.DeviceSumcheck, name,
                            lambda self, *a, _r=real, _n=name: seen.append(_n) or _r(self, *a))
    return seen


# ---------------------------------------------------------------- hyrax
def _hyrax_data(rng, n):
    witnesses = [[rng.randrange(P) for _ in range(8)] for _ in range(n)]
    inputs = [[rng.randrange(P) for _ in range(8)] for _ in range(n)]
    return witnesses, inputs


@pytest.fixture(scope="module")
def hyrax_run():
    """The JAX package's and the port's Hyrax proofs of tests/test_hyrax.py."""
    rng = random.Random(42)
    W, I = _hyrax_data(rng, 4)
    rparams = ref_hyrax.Parameters.new(REF_CURVE, rng, 8)
    rcirc = ref_hyrax.Circuit(8, 8, LAYERS)
    want = ref_hyrax.HyraxProof.prover(rparams, W, I, rcirc, rcirc.circuit_to_hash(REF_CURVE),
                                       rparams.param_to_hash(), 4, rng)
    rng = random.Random(42)
    _hyrax_data(rng, 4)
    params = hyrax.Parameters.new(CURVE, rng, 8, device="cpu")
    circ = hyrax.Circuit(8, 8, LAYERS)
    hashes = (circ.circuit_to_hash(CURVE), params.param_to_hash())
    got = hyrax.HyraxProof.prover(params, W, I, circ, *hashes, 4, rng, device="cpu")
    return (rparams, want), (params, circ, hashes, I, got)


def test_hyrax_equals_jax(hyrax_run):
    (rparams, (rproof, routputs)), (params, circ, hashes, I, (proof, outputs)) = hyrax_run
    assert ark_encode(CURVE, params) == ref_ark.ark_encode(REF_CURVE, rparams)
    assert ark_encode(CURVE, convert.hyrax_params_from_reference(rparams)) == \
        ref_ark.ark_encode(REF_CURVE, rparams)
    assert outputs == routputs
    assert ark_encode(CURVE, proof) == ref_ark.ark_encode(REF_CURVE, rproof)
    assert proof.verify(params, outputs, I, circ, *hashes, device="cpu")
    assert not proof.verify(params, _bad_first(outputs), I, circ, *hashes, device="cpu")


def test_hyrax_device_tables_give_the_host_proof(monkeypatch):
    """16 instances (tests/test_hyrax.py's device case): the three phases'
    tables on `DeviceSumcheck` (hyrax_p1_round, hyrax_p23_round) give the
    host path's proof."""
    rng = random.Random(11)
    W, I = _hyrax_data(rng, 16)
    params = hyrax.Parameters.new(CURVE, random.Random(2), 7, device="cpu")
    circ = hyrax.Circuit(8, 8, LAYERS)
    hashes = (circ.circuit_to_hash(CURVE), params.param_to_hash())
    monkeypatch.setattr(zk_sumcheck, "_use_device_tables", lambda n_, g_: False)
    want, out_w = hyrax.HyraxProof.prover(params, W, I, circ, *hashes, 16, random.Random(6),
                                          device="cpu")
    monkeypatch.setattr(zk_sumcheck, "_use_device_tables", lambda n_, g_: True)
    seen = _device_rounds(monkeypatch, ("hyrax_p1_round", "hyrax_p23_round"))
    got, out_g = hyrax.HyraxProof.prover(params, W, I, circ, *hashes, 16, random.Random(6),
                                         device="cpu")
    assert set(seen) == {"hyrax_p1_round", "hyrax_p23_round"}
    assert out_g == out_w
    assert ark_encode(CURVE, got) == ark_encode(CURVE, want)


# ---------------------------------------------------------------- libra
def _plain_fields(proof):
    return [dataclasses.astuple(layer) for layer in proof.proofs]


def test_libra_plain_equals_jax(monkeypatch):
    rcirc = ref_libra.Circuit(8, 8, LAYERS)
    rproof, routput = ref_libra.LinearGKRProof.prover(REF_CURVE, rcirc, INPUTS, WITNESSES,
                                                      rcirc.circuit_to_hash(REF_CURVE))
    circ = libra.Circuit(8, 8, LAYERS)
    chash = circ.circuit_to_hash(CURVE)
    assert chash == rcirc.circuit_to_hash(REF_CURVE)
    monkeypatch.setattr(linear_gkr, "_use_device", lambda bits: False)
    host, output = libra.LinearGKRProof.prover(CURVE, circ, INPUTS, WITNESSES, chash,
                                               device="cpu")
    monkeypatch.setattr(linear_gkr, "_use_device", lambda bits: True)
    seen = _device_rounds(monkeypatch, ("libra_p1_round", "libra_p2_round"))
    dev, out_d = libra.LinearGKRProof.prover(CURVE, circ, INPUTS, WITNESSES, chash,
                                             device="cpu")
    assert set(seen) == {"libra_p1_round", "libra_p2_round"}
    assert output == out_d == routput
    assert _plain_fields(host) == _plain_fields(dev) == _plain_fields(rproof)
    both = WITNESSES + INPUTS
    assert dev.verify(CURVE, circ, output, both, chash, device="cpu")
    assert not dev.verify(CURVE, circ, _bad_first(output), both, chash, device="cpu")


@pytest.fixture(scope="module")
def ref_libra_zk():
    """The JAX package's zk proof of tests/test_libra.py: (params, proof,
    output)."""
    rng = random.Random(88)
    rparams = ref_libra.Parameters.new(REF_CURVE, rng, 8)
    rcirc = ref_libra.Circuit(8, 8, LAYERS)
    rproof, routput = ref_libra.ZKLinearGKRProof.prover(
        rparams, rcirc, INPUTS, WITNESSES, rcirc.circuit_to_hash(REF_CURVE),
        rparams.param_to_hash(), rng)
    return rparams, rproof, routput


def test_libra_zk_equals_jax(ref_libra_zk, monkeypatch):
    rparams, rproof, routput = ref_libra_zk
    want = ref_ark.ark_encode(REF_CURVE, rproof)

    circ = libra.Circuit(8, 8, LAYERS)
    proofs = {}
    for on in (False, True):
        rng = random.Random(88)
        params = libra.Parameters.new(CURVE, rng, 8, device="cpu")
        hashes = (circ.circuit_to_hash(CURVE), params.param_to_hash())
        monkeypatch.setattr(zk_linear_gkr, "_use_device", lambda bits, _on=on: _on)
        seen = _device_rounds(monkeypatch, ("libra_p1_round", "libra_p2_round"))
        proofs[on], output = libra.ZKLinearGKRProof.prover(params, circ, INPUTS, WITNESSES,
                                                           *hashes, rng, device="cpu")
        assert bool(seen) == on
        assert output == routput
        assert ark_encode(CURVE, proofs[on]) == want
    assert ark_encode(CURVE, params) == ref_ark.ark_encode(REF_CURVE, rparams)
    assert ark_encode(CURVE, convert.libra_params_from_reference(rparams)) == \
        ref_ark.ark_encode(REF_CURVE, rparams)
    proof = proofs[True]
    assert proof.verify(params, circ, output, INPUTS, *hashes, device="cpu")
    assert not proof.verify(params, circ, _bad_first(output), INPUTS, *hashes, device="cpu")


# ---------------------------------------------------------------- contracts
@pytest.mark.parametrize("kind", ["libra", "hyrax"])
def test_contract_verifiers_give_the_jax_codes(kind, ref_libra_zk, hyrax_run):
    """The JAX package's cells of the reference circuits (BLS12-381), as
    tests/test_contracts.py makes them: vk, proof, publics, and publics
    with a changed output."""
    Tup, Vec, FR = ref_ark.Tup, ref_ark.Vec, ref_ark.FR
    if kind == "libra":
        params, proof, output = ref_libra_zk
        spec, inputs = Tup(Vec(FR), Vec(FR)), INPUTS
    else:
        (params, (proof, output)), (*_, inputs, _) = hyrax_run
        spec = Tup(Vec(Vec(FR)), Vec(Vec(FR)))
    enc = lambda v, s=None: ref_ark.ark_encode(REF_CURVE, v, s)  # noqa: E731
    vk, proof = enc(params), enc(proof)
    pub, bad = enc((inputs, output), spec), enc((inputs, _bad_first(output)), spec)
    name = ("mini_libra_zk_linear_gkr_verifier" if kind == "libra"
            else "mini_hyrax_zk_linear_gkr_verifier")
    port, ref = getattr(contracts, name), getattr(ref_contracts, name)
    circ = (libra.Circuit if kind == "libra" else hyrax.Circuit)(8, 8, LAYERS)
    rcirc = (ref_libra.Circuit if kind == "libra" else ref_hyrax.Circuit)(8, 8, LAYERS)
    cases = [(vk, proof, pub), (vk, proof, bad), (vk, proof[:-7], pub), (vk[:-3], proof, pub)]
    codes = [port("bls12_381", *c, circuit=circ, device="cpu") for c in cases]
    assert codes == [ref("bls12_381", *c, circuit=rcirc) for c in cases]
    assert codes == [contracts.OK, contracts.ERR_VERIFY, contracts.ERR_ENCODING,
                     contracts.ERR_ENCODING]

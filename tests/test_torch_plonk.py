"""The port's PLONK on BLS12-381 on the CPU, against the JAX package, as
`tests/test_plonk.py` drives it: the reference circuit (five gates, one
public input), `default_ks`, an SRS of degree 64 from `random.Random(21)`.

The composer's identities over the port's `HDomain`; the index (selector
and sigma polynomials, their evaluations, L1 and the vanishing poly's
inverses on the 4n coset) equal to the JAX package's, with the transforms
on the host and on the port's device NTT; the vk and proof bytes equal to
the JAX package's over its SRS (`convert.srs_from_reference`), keygen
and prove with `HDomain.HOST_SIZE` patched to 0 (every transform on the
device NTT, K1's plain version here); the port's own `Plonk.setup` from
the same seed limb for limb equal to that SRS (so keygen and prove over
it give the same bytes); the port's verdicts on its proof and on a
changed public input, with the verifier's transform on the host and on
the device NTT; the JAX package's decoder and verifier accepting the
port's bytes. The port's CPU MSMs cost about 2.8 s each at BLS12-381
whatever their size (a c = 8 Pippenger's 32 x 256 buckets of plain
12-word adds) and keygen and prove run 22, so the file runs one keygen
and prove. Tolerance: none (integers, points and bytes are exact). JAX
runs eagerly."""

import dataclasses
import random

import pytest
import torch

from ckb_zkp_tpu.host.pairing import get_curve as ref_curve
from ckb_zkp_tpu.schemes.plonk import Plonk as RefPlonk
from ckb_zkp_tpu.schemes.plonk import serialize as ref_pser
from ckb_zkp_tpu_torch.convert import srs_from_reference
from ckb_zkp_tpu_torch.host.pairing import get_curve
from ckb_zkp_tpu_torch.ops.hdomain import HDomain
from ckb_zkp_tpu_torch.schemes.plonk import Composer, Plonk, default_ks
from ckb_zkp_tpu_torch.schemes.plonk import serialize as pser

torch.set_num_threads(1)
CURVE = get_curve("bls12_381")
REF_CURVE = ref_curve("bls12_381")
P = CURVE.fr.modulus


def reference_circuit(composer_cls, p):
    """`tests/test_plonk.py`'s circuit, built by either package's composer."""
    cs = composer_cls(p)
    v1 = cs.alloc_and_assign(1)
    v2 = cs.alloc_and_assign(2)
    v3 = cs.alloc_and_assign(3)
    v4 = cs.alloc_and_assign(4)
    v6 = cs.alloc_and_assign(6)
    cs.create_add_gate((v1, 1), (v2, 1), v3)
    cs.create_add_gate((v1, 1), (v3, 1), v4)
    cs.create_mul_gate(v2, v2, v4)
    cs.create_mul_gate(v1, v2, v6, q_m=2, q_c=2)
    cs.constrain_to_constant(v6, 6)
    return cs


def _ref_composer():
    from ckb_zkp_tpu.schemes.plonk import Composer as RefComposer

    return reference_circuit(RefComposer, P)


@pytest.fixture(scope="module")
def ref_run():
    rng = random.Random(21)
    cs = _ref_composer()
    srs = RefPlonk.setup(REF_CURVE, 64, rng)
    state = rng.getstate()
    pk, vk = RefPlonk.keygen(REF_CURVE, srs, cs, default_ks(P))
    proof = RefPlonk.prove(REF_CURVE, pk, cs, rng)
    return {"srs": srs, "state": state,
            "vk": ref_pser.vk_to_bytes(REF_CURVE, vk),
            "proof": ref_pser.proof_to_bytes(REF_CURVE, proof)}


def port_prove(srs, state):
    """keygen and prove of the reference circuit over `srs`, the prover's
    rng in `state` (the seed's state after the setup)."""
    rng = random.Random()
    rng.setstate(state)
    cs = reference_circuit(Composer, P)
    pk, vk = Plonk.keygen(CURVE, srs, cs, default_ks(P))
    proof = Plonk.prove(CURVE, pk, cs, rng)
    return pk, vk, proof


@pytest.fixture(scope="module")
def port_run(ref_run):
    """keygen and prove over the JAX package's SRS with `HDomain.HOST_SIZE`
    at 0: every transform of the index and the prover on the device NTT."""
    sizes = []
    device = HDomain._device
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(HDomain, "HOST_SIZE", 0)
        mp.setattr(HDomain, "_device",
                   lambda self, xs, fn: sizes.append(self.size) or device(self, xs, fn))
        pk, vk, proof = port_prove(srs_from_reference(ref_run["srs"], "cpu"),
                                   ref_run["state"])
    return {"pk": pk, "vk": vk, "proof": proof, "sizes": sizes,
            "vk_bytes": pser.vk_to_bytes(CURVE, vk),
            "proof_bytes": pser.proof_to_bytes(CURVE, proof)}


@pytest.mark.parametrize("host_size", [256, 0])
def test_composer_identities_over_the_port_hdomain(monkeypatch, host_size):
    """`tests/test_plonk.py::test_composer_identities` on the port's
    composer, over the port's `HDomain` in either branch."""
    monkeypatch.setattr(HDomain, "HOST_SIZE", host_size)
    cs = reference_circuit(Composer, P)
    ks = default_ks(P)
    dn = HDomain(CURVE.fr, cs.size(), "cpu")
    roots = dn.elements
    sel, sigmas = cs.compose(roots, ks)
    w = cs.synthesize(dn.size)
    pi = cs.public_inputs() + [0] * (dn.size - cs.size())
    for i in range(dn.size):
        assert (
            w["w_0"][i] * sel["q_0"][i]
            + w["w_1"][i] * sel["q_1"][i]
            + w["w_2"][i] * sel["q_2"][i]
            + w["w_3"][i] * sel["q_3"][i]
            + w["w_1"][i] * w["w_2"][i] * sel["q_m"][i]
            + sel["q_c"][i]
            + pi[i]
        ) % P == 0
    rng = random.Random(9)
    beta, gamma = rng.randrange(P), rng.randrange(P)
    num = den = 1
    for i in range(dn.size):
        for wi, (k, sig) in enumerate(zip(ks, sigmas)):
            wv = w[f"w_{wi}"][i]
            num = num * ((wv + beta * roots[i] * k + gamma) % P) % P
            den = den * ((wv + beta * sig[i] + gamma) % P) % P
    assert num == den
    # the selector polynomials interpolate: back through the forward transform
    q_m = dn.ifft(sel["q_m"])
    assert dn.fft(q_m) == sel["q_m"]


@pytest.mark.parametrize("host_size", [256, 0])
def test_index_equals_the_reference(monkeypatch, host_size):
    monkeypatch.setattr(HDomain, "HOST_SIZE", host_size)
    want = RefPlonk.index(REF_CURVE, _ref_composer(), default_ks(P))
    got = Plonk.index(CURVE, reference_circuit(Composer, P), default_ks(P), "cpu")
    assert got.domain_n._host_mode == (host_size > 0)
    assert (got.info.n, got.info.ks) == (want.info.n, want.info.ks) == (8, [1, 7, 13, 17])
    for name in ("polys", "evals_n", "evals_4n", "l1_4n", "v_4n_inv"):
        assert getattr(got, name) == getattr(want, name), name


def test_vk_and_proof_bytes_equal_the_reference(ref_run, port_run):
    assert port_run["vk_bytes"] == ref_run["vk"]
    assert port_run["proof_bytes"] == ref_run["proof"]
    assert port_run["vk"].device == torch.device("cpu")
    # the index's (domains 8 and 32) and the prover's transforms ran there
    assert sorted(set(port_run["sizes"])) == [8, 32]
    assert not port_run["pk"].index.domain_n._host_mode


@pytest.mark.parametrize("host_size", [256, 0])
def test_port_verifies_and_refuses_a_wrong_public_input(monkeypatch, port_run, host_size):
    monkeypatch.setattr(HDomain, "HOST_SIZE", host_size)
    publics = reference_circuit(Composer, P).public_inputs()
    vk, proof = port_run["vk"], port_run["proof"]
    assert Plonk.verify(CURVE, vk, publics, proof) is True
    assert Plonk.verify(CURVE, vk, [1] + publics[1:], proof) is False


def test_reference_verifier_accepts_the_port_bytes(port_run):
    publics = _ref_composer().public_inputs()
    vk = ref_pser.vk_from_bytes(REF_CURVE, port_run["vk_bytes"])
    proof = ref_pser.proof_from_bytes(REF_CURVE, port_run["proof_bytes"])
    assert RefPlonk.verify(REF_CURVE, vk, publics, proof) is True
    assert RefPlonk.verify(REF_CURVE, vk, [1] + publics[1:], proof) is False


def test_port_bytes_round_trip_and_tamper(port_run):
    """`tests/test_plonk.py::test_plonk_ark_roundtrip` on the port's codec:
    the decoded vk and proof re-encode to the same bytes and verify; a
    flipped proof byte is refused at decode or verify."""
    vk_bytes, proof_bytes = port_run["vk_bytes"], port_run["proof_bytes"]
    vk2 = pser.vk_from_bytes(CURVE, vk_bytes)
    proof2 = pser.proof_from_bytes(CURVE, proof_bytes)
    assert pser.vk_to_bytes(CURVE, vk2) == vk_bytes
    assert pser.proof_to_bytes(CURVE, proof2) == proof_bytes
    assert vk2.device == "cuda"  # the default of the copied decoder: the card
    publics = reference_circuit(Composer, P).public_inputs()
    vk2 = dataclasses.replace(vk2, device="cpu")
    assert Plonk.verify(CURVE, vk2, publics, proof2) is True
    bad = bytearray(proof_bytes)
    bad[5] ^= 1
    try:
        ok = Plonk.verify(CURVE, vk2, publics, pser.proof_from_bytes(CURVE, bytes(bad)))
    except ValueError:
        ok = False
    assert not ok


def test_port_setup_equals_the_reference(ref_run):
    """The port's `Plonk.setup` from the same seed gives the JAX package's
    SRS limb for limb and draws as much of the seed. keygen and prove are
    deterministic in the SRS's tensors, so over this SRS they give the
    bytes of `port_run`, which equal the JAX package's."""
    rng = random.Random(21)
    srs = Plonk.setup(CURVE, 64, rng, device="cpu")
    assert rng.getstate() == ref_run["state"]
    want = srs_from_reference(ref_run["srs"], "cpu")
    for name in ("powers_of_g", "powers_of_gamma_g"):
        got, exp = getattr(srs, name), getattr(want, name)
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, exp)), name
        assert got[0].shape == (65, 24)
    assert (srs.g, srs.gamma_g, srs.h, srs.beta_h) == (want.g, want.gamma_g, want.h, want.beta_h)

"""The port's Groth16 front ends and key/proof bytes on the CPU, against
the JAX package.

The Mini circuit on BN254 through `generate_random_parameters` (a seeded
`random.Random`), `create_random_proof` and `create_proof_no_zk`, as
`tests/test_groth16.py` drives the JAX package: each proof verifies, a
wrong public input is refused, and keys and proofs equal the JAX
package's for the same seeds point for point. The ark-0.2 bytes of keys,
verifying keys and proofs equal the JAX package's on both curves (on
BLS12-381 for JAX host-mode keys and a JAX proof carried across, so no
port prove runs there), decoded keys give the layout that
`convert.params_from_reference` gives, the decoded BN254 keys prove the
same proof, and the pins of `tests/test_golden_bytes.py` hold for the
port's codecs. Tolerance: none (bytes and points are exact)."""

import io
import random

import pytest
import torch
from test_golden_bytes import FLAG_INF, ref_g1_bytes, ref_g2_bytes
from test_torch_msm import reference_host_cutoff  # noqa: F401 (autouse)

from ckb_zkp_tpu.bench_circuits import square_chain_shape as ref_square_chain
from ckb_zkp_tpu.circuits import Mini as RefMini
from ckb_zkp_tpu.host.pairing import get_curve as ref_curve
from ckb_zkp_tpu.r1cs import SynthesisMode as RefMode
from ckb_zkp_tpu.r1cs import synthesize as ref_synthesize
from ckb_zkp_tpu.schemes import groth16 as ref_groth16
from ckb_zkp_tpu.schemes.groth16 import serialize as ref_ser
from ckb_zkp_tpu.schemes.groth16.qap import QapMatrices as RefQap
from ckb_zkp_tpu_torch.circuits import Mini
from ckb_zkp_tpu_torch.convert import params_from_reference, point_from_reference
from ckb_zkp_tpu_torch.host.pairing import get_curve
from ckb_zkp_tpu_torch.schemes import groth16
from ckb_zkp_tpu_torch.schemes.groth16 import serialize
from ckb_zkp_tpu_torch.schemes.groth16.types import Proof
from ckb_zkp_tpu_torch.serialize.ark import G1Codec, G2Codec

torch.set_num_threads(1)
QUERIES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")
TOXIC = (11, 12, 13, 14, 15)  # alpha, beta, gamma, delta, t


def _pt(p):
    return (True, None, None) if p.infinity else (False, p.x, p.y)


def _proof(p):
    return [_pt(p.a), _pt(p.b), _pt(p.c)]


def _vk(vk):
    return ([_pt(p) for p in (vk.alpha_g1, vk.beta_g2, vk.gamma_g2, vk.delta_g2)]
            + [_pt(p) for p in vk.gamma_abc_g1])


def _port_proof(ref_proof):
    pt = point_from_reference
    return Proof(a=pt(ref_proof.a), b=pt(ref_proof.b), c=pt(ref_proof.c))


@pytest.fixture(scope="module")
def mini():
    """BN254 Mini keys from Random(42) (`generate_random_parameters`), a
    random proof from Random(7) (`create_random_proof`), and a no-zk proof
    (`create_proof_no_zk`) with the keys decoded from their own bytes; the
    JAX package's keys for the same toxic waste (drawn from Random(42) as
    its `generate_random_parameters` draws it) and its proofs for the same
    (r, s), by its host-int pipeline."""
    curve, rcurve = get_curve("bn254"), ref_curve("bn254")
    params = groth16.generate_random_parameters(Mini.power_off(), curve, random.Random(42),
                                                device="cpu")
    decoded = serialize.parameters_from_bytes(curve, serialize.parameters_to_bytes(params),
                                              device="cpu")
    circuit = Mini.power_on(2, 3, 10)
    rng = random.Random(42)
    toxic = [rng.randrange(1, rcurve.fr.modulus) for _ in range(5)]
    rshape = ref_synthesize(RefMini.power_off(), rcurve.fr.modulus, RefMode.SETUP)
    ref = ref_groth16.generate_parameters_from_shape(rshape, rcurve, *toxic, host_mode=True)
    pshape = ref_synthesize(RefMini.power_on(2, 3, 10), rcurve.fr.modulus, RefMode.PROVE)
    rng = random.Random(7)
    rs = (rng.randrange(rcurve.fr.modulus), rng.randrange(rcurve.fr.modulus))
    proofs = {
        "random": (groth16.create_random_proof(params, circuit, random.Random(7)),
                   _ref_prove(ref, pshape, *rs)),
        "no_zk": (groth16.create_proof_no_zk(decoded, circuit), _ref_prove(ref, pshape, 0, 0)),
    }
    return curve, params, ref, proofs, decoded


def _ref_prove(ref, shape, r, s):
    return ref_groth16.create_proof_from_shape(
        ref, shape, r, s, qap=RefQap(shape, ref.curve.fr, host_mode=True))


@pytest.mark.parametrize("kind", ["random", "no_zk"])
def test_mini_front_ends_prove_verify_and_equal_the_reference(mini, kind):
    """Each front end's proof verifies, a wrong public input is refused,
    and it equals the JAX package's proof for the same keys and (r, s)
    (the no-zk proof comes from the keys decoded from their bytes)."""
    curve, params, ref, proofs, _ = mini
    proof, want = proofs[kind]
    assert _vk(params.vk) == _vk(ref.vk)
    assert _proof(proof) == _proof(want)
    assert curve.g1.is_on_curve(proof.a) and curve.g2.is_on_curve(proof.b)
    pvk = groth16.prepare_verifying_key(curve, params.vk)
    assert groth16.verify_proof(curve, pvk, proof, [10])
    assert not groth16.verify_proof(curve, pvk, proof, [11])
    assert not groth16.verify_proof(curve, pvk, proof, [10, 1])


def test_mini_bytes_equal_the_reference_and_decoded_keys_prove_the_same(mini):
    """Parameter, vk and proof bytes of the Mini keys equal the JAX
    package's; `parameters_from_bytes` gives the keys (the exact layout
    below the padding cutoff) that `params_from_reference` carries across
    from the JAX package's decoding, and they prove the no-zk proof of the
    same keys (the JAX package's, equal point for point to the port's)."""
    curve, params, ref, proofs, decoded = mini
    rcurve = ref_curve("bn254")
    data = serialize.parameters_to_bytes(params)
    assert data == ref_ser.parameters_to_bytes(ref)
    assert serialize.vk_to_bytes(curve, params.vk) == ref_ser.vk_to_bytes(rcurve, ref.vk)
    proof, want = proofs["random"]
    pb = serialize.proof_to_bytes(curve, proof)
    assert pb == ref_ser.proof_to_bytes(rcurve, want)
    assert _proof(serialize.proof_from_bytes(curve, pb)) == _proof(proof)
    assert serialize.vk_from_bytes(curve, serialize.vk_to_bytes(curve, params.vk)) == params.vk
    _same_layout(decoded, params_from_reference(ref_ser.parameters_from_bytes(rcurve, data),
                                                "cpu"))
    assert not decoded.padded_queries and decoded.vk == params.vk
    again, want = proofs["no_zk"]
    assert _proof(again) == _proof(want)
    assert serialize.parameters_to_bytes(decoded) == data


def _same_layout(got, want):
    assert got.padded_queries == want.padded_queries
    assert (got.domain_size, got.num_inputs, got.num_aux) == \
        (want.domain_size, want.num_inputs, want.num_aux)
    assert got.vk == want.vk
    assert (got.beta_g1, got.delta_g1) == (want.beta_g1, want.delta_g1)
    for name in QUERIES:
        g, w = getattr(got, name), getattr(want, name)
        assert all(torch.equal(a, b) for a, b in zip(g, w)), name


def test_bls12_381_bytes_equal_the_reference():
    """JAX host-mode keys and a JAX proof of the m = 16 square chain on
    BLS12-381, carried across: the port's parameter, vk and proof bytes
    equal the JAX package's, and the port decodes the key bytes to the
    keys `params_from_reference` gives from the JAX package's decoding."""
    rcurve, curve = ref_curve("bls12_381"), get_curve("bls12_381")
    shape = ref_square_chain(14, rcurve.fr.modulus)
    ref = ref_groth16.generate_parameters_from_shape(shape, rcurve, *TOXIC, host_mode=True)
    want = _ref_prove(ref, shape, 5, 6)
    params = params_from_reference(ref, "cpu")
    data = serialize.parameters_to_bytes(params)
    assert data == ref_ser.parameters_to_bytes(ref)
    assert serialize.vk_to_bytes(curve, params.vk) == ref_ser.vk_to_bytes(rcurve, ref.vk)
    proof = _port_proof(want)
    assert serialize.proof_to_bytes(curve, proof) == ref_ser.proof_to_bytes(rcurve, want)
    _same_layout(serialize.parameters_from_bytes(curve, data, device="cpu"),
                 params_from_reference(ref_ser.parameters_from_bytes(rcurve, data), "cpu"))


def test_padded_keys_decode_to_the_reference_layout():
    """Keys above the padding cutoff (601 columns; infinity among the
    points) decode to the reference's padded layout: G1 and G2 queries at
    the next power of two, h_query at m rows, l_query with infinity at the
    input slots, limb for limb what `params_from_reference` carries across
    from the JAX package's `parameters_from_bytes`."""
    rcurve, curve = ref_curve("bn254"), get_curve("bn254")
    g1c, g2c = G1Codec(curve), G2Codec(curve)
    rng = random.Random(3)
    g1 = [curve.g1.mul(curve.g1_gen, rng.randrange(1, 1 << 64)) for _ in range(16)]
    g2 = [curve.g2.mul(curve.g2_gen, rng.randrange(1, 1 << 64)) for _ in range(16)]
    g1[5], g2[7] = curve.g1.infinity, curve.g2.infinity
    nv, ni, m = 601, 2, 512

    def vec(codec, pts, n):
        return n.to_bytes(8, "little") + b"".join(codec.to_bytes(pts[i % 16])
                                                   for i in range(n))

    data = (g1c.to_bytes(g1[1]) + g2c.to_bytes(g2[1]) + g2c.to_bytes(g2[2])
            + g2c.to_bytes(g2[3]) + vec(g1c, g1, ni) + g1c.to_bytes(g1[4])
            + g1c.to_bytes(g1[6]) + vec(g1c, g1, nv) + vec(g1c, g1[3:] + g1[:3], nv)
            + vec(g2c, g2, nv) + vec(g1c, g1[5:] + g1[:5], m - 1) + vec(g1c, g1, nv - ni))
    got = serialize.parameters_from_bytes(curve, data, device="cpu")
    _same_layout(got, params_from_reference(ref_ser.parameters_from_bytes(rcurve, data),
                                            "cpu"))
    assert got.padded_queries and got.a_query[0].shape[0] == 1024
    assert got.h_query[0].shape[0] == m
    assert serialize.parameters_to_bytes(got) == data


def test_golden_byte_pins_hold_for_the_port_codecs(mini):
    """tests/test_golden_bytes.py's independent encoder and literal pins,
    on the port's copies of the codecs, both curves, and the layout of a
    port verifying key's bytes."""
    curve = get_curve("bn254")
    g1c = G1Codec(curve)
    assert g1c.to_bytes(curve.g1_gen) == bytes.fromhex("01" + "00" * 31)
    assert g1c.to_bytes(curve.g1.infinity) == bytes(31) + bytes([FLAG_INF])
    for name in ("bn254", "bls12_381"):
        curve = get_curve(name)
        for codec, group, gen, enc, k in (
                (G1Codec(curve), curve.g1, curve.g1_gen, ref_g1_bytes, 7),
                (G2Codec(curve), curve.g2, curve.g2_gen, ref_g2_bytes, 11)):
            for pt in (gen, group.mul(gen, k), group.neg(gen), group.infinity):
                assert codec.to_bytes(pt) == enc(curve, pt), (name, pt)
                assert codec.read(io.BytesIO(codec.to_bytes(pt))) == pt
    curve, params = mini[:2]
    vk = params.vk
    assert serialize.vk_to_bytes(curve, vk) == (
        ref_g1_bytes(curve, vk.alpha_g1) + ref_g2_bytes(curve, vk.beta_g2)
        + ref_g2_bytes(curve, vk.gamma_g2) + ref_g2_bytes(curve, vk.delta_g2)
        + len(vk.gamma_abc_g1).to_bytes(8, "little")
        + b"".join(ref_g1_bytes(curve, pt) for pt in vk.gamma_abc_g1))

"""The port's own copies of the JAX package's host layers (fields, curves,
pairings, R1CS, benchmark circuits, Groth16 types and verifier, the ark-0.2
codecs, the framework codec, the Edwards curves, the gadgets and the Mini
and Hash circuits) against the originals: each exact copy's text
is its original's under a header naming it, and the same circuits array
for array, the same curve arithmetic, and the same verifier verdicts."""

import ast
import os
import re

import numpy as np
import pytest
from test_torch_msm import reference_host_cutoff  # noqa: F401 (autouse)

from ckb_zkp_tpu import bench_circuits as ref_circuits
from ckb_zkp_tpu.host.pairing import get_curve
from ckb_zkp_tpu.schemes import groth16 as ref_groth16
from ckb_zkp_tpu.schemes.groth16.qap import QapMatrices as RefQap
from ckb_zkp_tpu.transcript import merlin as ref_merlin
from ckb_zkp_tpu_torch import bench_circuits as port_circuits
from ckb_zkp_tpu_torch.convert import point_from_reference
from ckb_zkp_tpu_torch.host.pairing import get_curve as port_curve
from ckb_zkp_tpu_torch.r1cs import R1csShape
from ckb_zkp_tpu_torch.schemes import groth16
from ckb_zkp_tpu_torch.schemes.groth16.types import Proof
from ckb_zkp_tpu_torch.transcript import merlin

CURVE = get_curve("bn254")
FR = CURVE.fr.modulus
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the copies kept word for word (r1cs/system.py leaves out the witness cache;
# transcript/merlin.py runs its byte work in C: test_merlin_* below)
EXACT_COPIES = ("host/curves.py", "host/field.py", "host/pairing.py", "host/tower.py",
                "r1cs/lc.py", "bench_circuits.py", "schemes/groth16/types.py",
                "schemes/groth16/verifier.py", "serialize/ark.py", "circuits/mini.py",
                "transcript/__init__.py", "transcript/keccak.py", "transcript/chacha.py", "host/poly.py", "serialize/tobytes.py",
                "schemes/errors.py", "schemes/marlin/fs_rng.py",
                "schemes/plonk/composer.py", "schemes/plonk/__init__.py",
                "schemes/plonk/serialize.py", "host/ristretto.py",
                "schemes/spartan/polynomial.py", "schemes/spartan/__init__.py",
                "schemes/bulletproofs/common.py", "schemes/bulletproofs/__init__.py",
                "schemes/hyrax/circuit.py", "schemes/hyrax/__init__.py",
                "schemes/libra/circuit.py", "schemes/libra/__init__.py",
                "host/edwards_groups.py", "serialize/struct_codec.py", "circuits/hash.py",
                *(f"gadgets/{name}.py" for name in (
                    "__init__", "abstract_hash", "blake2s", "boolean", "cbmt", "fr", "lookup",
                    "mimc", "multieq", "poseidon", "rangeproof", "rescue", "sha256",
                    "test_constraint_system", "uint32")))


# the functions a copy rewrites, each compared by its own test:
# struct_codec's self-registering decode would import the JAX package
REWRITTEN = {"serialize/struct_codec.py": ("_resolve_qualname",)}


def _without(text, names):
    """`text` with the top-level functions `names` taken out."""
    lines = text.splitlines(keepends=True)
    for node in reversed(ast.parse(text).body):
        if isinstance(node, ast.FunctionDef) and node.name in names:
            del lines[node.lineno - 1:node.end_lineno]
    return "".join(lines)


@pytest.mark.parametrize("path", EXACT_COPIES)
def test_copy_matches_its_original(path):
    """The copy is a header line naming its original, then the original's
    text, where the original's absolute paths to the Rust sources read
    `ckb-zkp <path>`, but for the functions REWRITTEN names."""
    with open(os.path.join(REPO, "ckb_zkp_tpu", path)) as f:
        original = f.read()
    with open(os.path.join(REPO, "ckb_zkp_tpu_torch", path)) as f:
        header, _, copy = f.read().partition("\n")
    assert header.startswith(f"# Copied from ckb_zkp_tpu/{path} ")
    names = REWRITTEN.get(path, ())
    assert _without(copy, names) == _without(re.sub(r"(/\w+)+/reference/", "ckb-zkp ", original), names)


def test_merlin_known_vector():
    """merlin's own `equivalence_simple` vector through the port's C STROBE."""
    t = merlin.Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_merlin_equals_the_reference(seed, monkeypatch):
    """Random transcripts (messages across the 166-byte block edge, u64s,
    challenges of 0-500 bytes, more messages than one queue holds, with
    the queue cut to 5) give the reference transcript's challenges and
    state, and the STROBE ops (key, a continued op, a flag mismatch) its
    bytes."""
    monkeypatch.setattr(merlin, "_QUEUE_MAX", 5)
    rng = np.random.default_rng(seed)
    rand = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()  # noqa: E731
    label = rand(int(rng.integers(0, 20)))
    want, got = ref_merlin.Transcript(label), merlin.Transcript(label)
    for _ in range(60):
        k, lbl = rng.random(), rand(int(rng.integers(0, 30)))
        if k < 0.6:
            m = rand(int(rng.choice([0, 1, 8, 32, 165, 166, 167, 400])))
            want.append_message(lbl, m)
            got.append_message(lbl, bytearray(m))
        elif k < 0.7:
            x = int(rng.integers(0, 1 << 63))
            want.append_u64(lbl, x)
            got.append_u64(lbl, x)
        else:
            n = int(rng.choice([0, 1, 31, 64, 200, 500]))
            assert got.challenge_bytes(lbl, n) == want.challenge_bytes(lbl, n)
    for i in range(13):
        want.append_u64(b"i", i)
        got.append_u64(b"i", i)
    got.append_messages([b"m"] * 7, [bytes([i]) * i for i in range(7)])
    for i in range(7):
        want.append_message(b"m", bytes([i]) * i)
    assert got.challenge_bytes(b"end", 32) == want.challenge_bytes(b"end", 32)
    assert got.strobe.state == bytes(want.strobe.state)
    a, b = ref_merlin.Strobe128(b"p"), merlin.Strobe128(b"p")
    for s in (a, b):
        s.key(rand(0) + b"key bytes" * 20, False)
        s.ad(b"x", False)
        s.ad(b"y", True)
    assert b.prf(40, False) == a.prf(40, False) and b.state == bytes(a.state)
    with pytest.raises(AssertionError, match="flag mismatch"):
        b.ad(b"z", True)


@pytest.mark.parametrize("circuit,n", [("square_chain_shape", 62),
                                       ("product_circuit_shape", 20)])
def test_circuits_equal_the_reference_array_for_array(circuit, n):
    want = getattr(ref_circuits, circuit)(n, FR, seed=9)
    got = getattr(port_circuits, circuit)(n, FR, seed=9)
    assert isinstance(got, R1csShape)
    for k in ("num_inputs", "num_aux", "num_constraints", "p",
              "input_assignment", "aux_assignment"):
        assert getattr(got, k) == getattr(want, k), k
    for mat in ("a", "b", "c"):
        g, w = getattr(got, mat), getattr(want, mat)
        assert np.array_equal(g.rows, w.rows) and g.rows.dtype == w.rows.dtype
        assert np.array_equal(g.cols, w.cols) and g.cols.dtype == w.cols.dtype
        assert g.coeffs == w.coeffs
    assert not hasattr(got, "witness_limbs")


def test_curve_arithmetic_equals_the_reference():
    pc = port_curve("bn254")
    rng = np.random.default_rng(11)
    for k in (int(x) for x in rng.integers(1, 1 << 62, size=3)):
        for g, pg, gen, pgen in ((CURVE.g1, pc.g1, CURVE.g1_gen, pc.g1_gen),
                                 (CURVE.g2, pc.g2, CURVE.g2_gen, pc.g2_gen)):
            want, got = g.mul(gen, k), pg.mul(pgen, k)
            assert (got.x, got.y, got.infinity) == (want.x, want.y, want.infinity)
    assert (pc.fr.modulus, pc.fq.modulus) == (CURVE.fr.modulus, CURVE.fq.modulus)


def test_port_verifier_gives_the_reference_verdicts():
    shape = ref_circuits.square_chain_shape(30, FR)
    params = ref_groth16.generate_parameters_from_shape(
        shape, CURVE, 5, 6, 7, 8, 9, host_mode=True)
    # the reference's host-int prover (no witness-map compiles): the same proof
    proof = ref_groth16.create_proof_from_shape(
        params, shape, 3, 4, qap=RefQap(shape, CURVE.fr, host_mode=True))
    publics = shape.input_assignment[1:]
    pc = port_curve("bn254")
    pt = point_from_reference
    vk = groth16.VerifyKey(
        alpha_g1=pt(params.vk.alpha_g1), beta_g2=pt(params.vk.beta_g2),
        gamma_g2=pt(params.vk.gamma_g2), delta_g2=pt(params.vk.delta_g2),
        gamma_abc_g1=[pt(g) for g in params.vk.gamma_abc_g1])
    pvk = groth16.prepare_verifying_key(pc, vk)
    rpvk = ref_groth16.prepare_verifying_key(CURVE, params.vk)
    port_proof = Proof(a=pt(proof.a), b=pt(proof.b), c=pt(proof.c))
    swapped = Proof(a=pt(proof.a), b=pt(proof.b), c=pt(proof.a))
    ref_swapped = type(proof)(a=proof.a, b=proof.b, c=proof.a)
    for p_proof, r_proof, pubs in (
        (port_proof, proof, publics),
        (port_proof, proof, [(publics[0] + 1) % FR]),
        (swapped, ref_swapped, publics),
    ):
        want = ref_groth16.verify_proof(CURVE, rpvk, r_proof, pubs)
        assert groth16.verify_proof(pc, pvk, p_proof, pubs) == want
    assert ref_groth16.verify_proof(CURVE, rpvk, proof, publics) is True

"""The port's gadget library and hash circuit against the JAX package's.

Each case synthesizes the same gadget on the same inputs (drawn from a
seeded `random.Random`) into a `TestConstraintSystem` of each package, and
the two give the same constraints, row for row (names, and each linear
combination's variables and coefficients in order), the same public and
witness assignments, and a satisfied system: MiMC, Poseidon, Rescue,
BLAKE2s (one compression), one SHA-256 compression, the CBMT membership
gadget under MiMC, and the CLI's MiMC `Hash` circuit (the SHA-256 CBMT
circuit runs at 5 lemmas on the card, in chip_smoke.py). The copies'
text is held by `test_torch_host.py`'s EXACT_COPIES; these cases show that
the copies run on the port's own `r1cs`, `host.field` and `transcript`.
Tolerance: none (integers are exact)."""

import importlib
import random
from types import SimpleNamespace

import pytest

from ckb_zkp_tpu.host.pairing import get_curve as ref_curve
from ckb_zkp_tpu_torch.host.pairing import get_curve

PACKAGES = ("ckb_zkp_tpu", "ckb_zkp_tpu_torch")


def _pkg(name: str, curve: str = "bn254"):
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    g = mod("gadgets")
    return SimpleNamespace(
        g=g, mimc=mod("gadgets.mimc"), poseidon=mod("gadgets.poseidon"),
        rescue=mod("gadgets.rescue"), blake2s=mod("gadgets.blake2s"),
        sha256=mod("gadgets.sha256"), cbmt=mod("gadgets.cbmt"), circuits=mod("circuits"),
        fr=(ref_curve if name == "ckb_zkp_tpu" else get_curve)(curve).fr)


def _bits(k, cs, bits):
    return [k.g.Boolean.from_bit(k.g.AllocatedBit.alloc(cs, int(b))) for b in bits]


def _mimc(k, cs, rng):
    k.mimc.mimc_gadget(cs, k.fr, rng.randbytes(100))


def _poseidon(k, cs, rng):
    k.poseidon.poseidon_gadget(cs, k.fr, rng.randbytes(100))


def _rescue(k, cs, rng):
    k.rescue.rescue_gadget(cs, k.fr, rng.randbytes(64))


def _blake2s(k, cs, rng):
    bits = _bits(k, cs, k.blake2s.bytes_to_bits_le(rng.randbytes(32)))
    k.blake2s.blake2s(cs, k.fr.modulus, bits, b"ZcashPrf")


def _sha256_compression(k, cs, rng):
    bits = _bits(k, cs, k.sha256.bytes_to_bits_be(rng.randbytes(64)))
    k.sha256.sha256_block_no_padding(cs, k.fr.modulus, bits)


def _cbmt_mimc(k, cs, rng):
    """merkle_tree_mimc.rs: leaf 2 of a 4-leaf tree under MiMC."""
    spec, mimc = k.fr, k.mimc
    leaves = [rng.randrange(spec.modulus) for _ in range(4)]

    def merge(left, right):
        return mimc.hash_bytes(spec, left.to_bytes(spec.nbytes, "little")
                               + right.to_bytes(spec.nbytes, "little"))

    proof = k.cbmt.build_merkle_tree(leaves, merge).build_proof(2)
    root = k.cbmt.build_merkle_root(leaves, merge)
    n_root = mimc.AbstractHashMimcOutput.alloc_input(cs, root)
    n_leaf = mimc.AbstractHashMimcOutput.alloc(cs, leaves[2])
    lemmas = [mimc.AbstractHashMimcOutput.alloc(cs, v) for v in proof.lemmas]
    k.cbmt.MerkleProofGadget(proof.index, lemmas, mimc.AbstractHashMimc(spec)).set_membership(
        cs, n_root, n_leaf)


def _hash_circuit(k, cs, rng):
    k.circuits.Hash.power_on(k.fr, rng.randbytes(20)).generate_constraints(cs)


CASES = {"mimc": _mimc, "poseidon": _poseidon, "rescue": _rescue, "blake2s": _blake2s,
         "sha256_compression": _sha256_compression, "cbmt_mimc": _cbmt_mimc,
         "hash_circuit": _hash_circuit}


def _rows(cs):
    """The system as plain data: each constraint's name and its three
    linear combinations' (kind, index, coefficient) terms in order."""
    lc = lambda c: [(v.kind, v.index, x) for v, x in c.terms.items()]  # noqa: E731
    return [(name, lc(a), lc(b), lc(c)) for name, a, b, c in cs.constraints]


def _synthesize(name: str, case: str, seed: int):
    k = _pkg(name)
    cs = k.g.TestConstraintSystem(k.fr.modulus)
    CASES[case](k, cs, random.Random(seed))
    return cs


@pytest.mark.parametrize("case", list(CASES))
def test_gadget_rows_and_assignment_equal_the_reference(case):
    want, got = (_synthesize(name, case, 17) for name in PACKAGES)
    assert got.is_satisfied() and want.is_satisfied()
    assert got.num_constraints == want.num_constraints > 0
    assert _rows(got) == _rows(want)
    assert got.input_values == want.input_values
    assert got.aux_values == want.aux_values
    assert got.hash() == want.hash()


def test_hash_circuit_is_one_mimc_block_pair():
    """The CLI's `Hash` circuit: 644 constraints whatever the preimage's
    length (one block pair of `mimc_gadget`), its public input the native
    hash. As in the JAX package (and ckb-zkp cli/src/circuits/hash.rs), no
    constraint ties that input to the gadget's output, so a changed image
    is refused by a proof system's verifier, not by the constraints."""
    k = _pkg("ckb_zkp_tpu_torch")
    for n in (1, 32, 100):
        cs = k.g.TestConstraintSystem(k.fr.modulus)
        c = k.circuits.Hash.power_on(k.fr, bytes(range(n)))
        c.generate_constraints(cs)
        assert cs.num_constraints == 644 and cs.is_satisfied()
        assert cs.input_values[1:] == c.publics == [k.mimc.hash_bytes(k.fr, bytes(range(n)))]

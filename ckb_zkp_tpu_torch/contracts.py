"""Portable verifier entry points mirroring the on-chain contracts.

Port of the reference's `contracts.py`: the error codes, `_frs_from_cell`,
the mini GKR circuit and the Groth16, Marlin, PLONK, Spartan (NIZK and
SNARK), Bulletproofs, Libra and Hyrax entry points word for word, routed
to the port's schemes and codecs. The reference ships 10
no_std RISC-V contracts that load vk / proof / public-input bytes from
transaction cell data and run the layer-3 verifier inside CKB-VM (ckb-zkp
ckb-contracts/contracts/universal_groth16_verifier/src/entry.rs:12-42);
these entry points keep their cell-data semantics: three byte strings in,
accept/reject out, over the same ark-0.2 wire formats
(serialize/ark_schemes.py):

- groth16 / marlin / plonk / spartan x2: vk cell = key bytes, proof cell =
  proof bytes, publics = Fr bytes (plonk: Vec<Fr> with u64 length prefix,
  as its entry.rs reads; the rest: concatenated 32/48-byte Fr words);
- bulletproofs: proof cell = (Generators, R1csCircuit, Proof) concatenated
  (mini_bulletproofs_verifier/src/entry.rs:66-69), vk cell unused;
- libra / hyrax: vk cell = Parameters bytes, publics cell = the reference's
  (inputs, outputs) tuple encoding; the circuit is compiled into the
  contract (reference hardcodes the mini layers in entry.rs) — pass
  `circuit=` for other circuits.

Groth16's verifier is host ints only. Marlin's and PLONK's verifiers run
their `HDomain` transforms above `HDomain.HOST_SIZE` on a device: they
take `device` (default "cuda") and decode the verifying key onto it.
Spartan's, Libra's and Hyrax's verifiers take `device` for their
Pedersen commitments of FIXED_BASE_MSM_MIN scalars or more and for the
square roots of the keys' long generator lists
(`ark_schemes.DEVICE_DECODE_MIN`); Bulletproofs' verifier is host ints
and takes `device` for the generators' square roots. The `except` clauses
map decode and verify errors to the cell codes as the reference does; an
error of a CUDA launch (a RuntimeError) is not a verdict and propagates.
"""

from __future__ import annotations

import dataclasses

from .host.pairing import get_curve
from .schemes import groth16
from .schemes.groth16 import serialize as g16ser
from .serialize.ark_schemes import FR, S, Tup, Vec, ark_decode

# error codes mirror the contracts' i8 Error enums (entry.rs / error.rs)
OK = 0
ERR_ENCODING = 1
ERR_VERIFY = 2

# the mini circuit (x * (y + 2) = z) as layered GKR gates — hardcoded in the
# reference's libra/hyrax contracts (mini_libra_zk_linear_gkr_verifier/src/
# entry.rs:13-34: Circuit::new(4, 4, &layers()))
MINI_GKR_LAYERS = (
    [(0, 1, 2), (1, 0, 4), (1, 3, 4), (1, 4, 4)],
    [(1, 0, 1), (1, 2, 3)],
    [(0, 0, 1)],
)
MINI_GKR_SIZE = (4, 4)

def _frs_from_cell(curve, publics_cell: bytes) -> list[int] | None:
    """Concatenated fixed-width Fr words -> ints, or None on bad encoding."""
    nb = curve.fr.nbytes
    if len(publics_cell) % nb:
        return None
    out = [
        int.from_bytes(publics_cell[i : i + nb], "little")
        for i in range(0, len(publics_cell), nb)
    ]
    if any(x >= curve.fr.modulus for x in out):
        return None
    return out


def universal_groth16_verifier(
    curve_name: str, vk_cell: bytes, proof_cell: bytes, publics_cell: bytes
) -> int:
    """entry::main for the groth16 contract: cells 0/1/2 = vk, proof, publics."""
    curve = get_curve(curve_name)
    try:
        vk = g16ser.vk_from_bytes(curve, vk_cell)
        proof = g16ser.proof_from_bytes(curve, proof_cell)
        nb = curve.fr.nbytes
        if len(publics_cell) % nb:
            return ERR_ENCODING
        publics = [
            int.from_bytes(publics_cell[i : i + nb], "little")
            for i in range(0, len(publics_cell), nb)
        ]
        if any(x >= curve.fr.modulus for x in publics):
            return ERR_ENCODING
    except (ValueError, EOFError, IndexError):
        return ERR_ENCODING
    pvk = groth16.prepare_verifying_key(curve, vk)
    return OK if groth16.verify_proof(curve, pvk, proof, publics) else ERR_VERIFY


def universal_marlin_verifier(
    curve_name: str, vk_cell: bytes, proof_cell: bytes, publics_cell: bytes,
    device="cuda",
) -> int:
    """universal_marlin_verifier/src/entry.rs: cells = ivk, proof, publics
    (all ark-0.2 CanonicalSerialize bytes); the ivk is decoded onto
    `device`."""
    curve = get_curve(curve_name)
    from .schemes.marlin import marlin

    try:
        ivk = ark_decode(curve, vk_cell, marlin.IndexVerifierKey, device)
        proof = ark_decode(curve, proof_cell, marlin.Proof)
        publics = _frs_from_cell(curve, publics_cell)
        if publics is None:
            return ERR_ENCODING
    except (ValueError, EOFError, IndexError, TypeError):
        return ERR_ENCODING
    try:
        ok = marlin.verify_proof(ivk, proof, publics)
    except (ValueError, AssertionError, ZeroDivisionError, IndexError):
        return ERR_VERIFY
    return OK if ok else ERR_VERIFY


def universal_plonk_verifier(
    curve_name: str, vk_cell: bytes, proof_cell: bytes, publics_cell: bytes,
    device="cuda",
) -> int:
    """universal_plonk_verifier/src/entry.rs: ark vk + proof bytes; publics
    cell = Vec<Fr> (u64 length prefix, entry.rs:49-50); the vk is decoded
    onto `device`."""
    curve = get_curve(curve_name)
    from .schemes.plonk import serialize as pser
    from .schemes.plonk.plonk import Plonk

    try:
        vk = dataclasses.replace(pser.vk_from_bytes(curve, vk_cell), device=device)
        proof = pser.proof_from_bytes(curve, proof_cell)
        publics = ark_decode(curve, publics_cell, Vec(FR))
    except (ValueError, EOFError, IndexError, TypeError):
        return ERR_ENCODING
    try:
        ok = Plonk.verify(curve, vk, list(publics), proof)
    except (ValueError, AssertionError, ZeroDivisionError, IndexError):
        return ERR_VERIFY
    return OK if ok else ERR_VERIFY


def universal_spartan_nizk_verifier(
    curve_name: str, vk_cell: bytes, proof_cell: bytes, publics_cell: bytes,
    device="cuda",
) -> int:
    """universal_spartan_nizk_verifier/src/entry.rs: vk cell = ark VerifyKey
    {params, r1cs} (lib.rs:163-166), proof cell = ark NIZKProof."""
    curve = get_curve(curve_name)
    from .schemes.spartan import nizk
    from .schemes.spartan.common import NizkParameters

    try:
        params, r1cs = ark_decode(
            curve, vk_cell, Tup(S(NizkParameters), S(nizk.R1CSInstance)), device
        )
        proof = ark_decode(curve, proof_cell, nizk.NIZKProof, device)
        publics = _frs_from_cell(curve, publics_cell)
        if publics is None:
            return ERR_ENCODING
    except (ValueError, EOFError, IndexError, TypeError):
        return ERR_ENCODING
    try:
        ok = nizk.verify_nizk_proof(
            curve, params, r1cs, publics, proof,
            r1cs.r1cs_to_hash(), nizk.params_to_hash(curve, params), device=device,
        )
    except (ValueError, AssertionError, ZeroDivisionError, IndexError):
        return ERR_VERIFY
    return OK if ok else ERR_VERIFY


def universal_spartan_snark_verifier(
    curve_name: str, vk_cell: bytes, proof_cell: bytes, publics_cell: bytes,
    device="cuda",
) -> int:
    """universal_spartan_snark_verifier: vk cell = ark VerifyKey {params,
    r1cs, encode_comm} (lib.rs:59-63), proof cell = ark SNARKProof."""
    curve = get_curve(curve_name)
    from .schemes.spartan import nizk, snark

    try:
        params, r1cs, encode_commit = ark_decode(
            curve, vk_cell,
            Tup(
                S(snark.SnarkParameters),
                S(nizk.R1CSInstance),
                S(snark.EncodeCommit),
            ),
            device,
        )
        proof = ark_decode(curve, proof_cell, snark.SNARKProof, device)
        publics = _frs_from_cell(curve, publics_cell)
        if publics is None:
            return ERR_ENCODING
    except (ValueError, EOFError, IndexError, TypeError):
        return ERR_ENCODING
    try:
        ok = snark.verify_snark_proof(
            curve, params, r1cs, publics, proof, encode_commit,
            r1cs.r1cs_to_hash(),
            snark.snark_params_to_hash(curve, params),
            snark.encode_to_hash(curve, encode_commit),
            device=device,
        )
    except (ValueError, AssertionError, ZeroDivisionError, IndexError):
        return ERR_VERIFY
    return OK if ok else ERR_VERIFY


def mini_bulletproofs_verifier(
    curve_name: str, vk_cell: bytes, proof_cell: bytes, publics_cell: bytes,
    device="cuda",
) -> int:
    """mini_bulletproofs_verifier: proof cell = ark (Generators, R1csCircuit,
    Proof) concatenated (entry.rs:66-69); the vk cell is unused."""
    curve = get_curve(curve_name)
    from .schemes.bulletproofs import arithmetic_circuit as bp

    try:
        gens, r1cs, proof = ark_decode(
            curve, proof_cell,
            Tup(S(bp.Generators), S(bp.R1csCircuit), S(bp.Proof)), device,
        )
        publics = _frs_from_cell(curve, publics_cell)
        if publics is None:
            return ERR_ENCODING
    except (ValueError, EOFError, IndexError, TypeError):
        return ERR_ENCODING
    try:
        ok = bp.verify_proof(curve, gens, proof, r1cs, publics)
    except (ValueError, AssertionError, ZeroDivisionError, IndexError):
        return ERR_VERIFY
    return OK if ok else ERR_VERIFY


def mini_libra_zk_linear_gkr_verifier(
    curve_name: str, vk_cell: bytes, proof_cell: bytes, publics_cell: bytes,
    circuit=None, device="cuda",
) -> int:
    """mini_libra_zk_linear_gkr_verifier: vk cell = ark Parameters, proof
    cell = ark ZKLinearGKRProof, publics cell = ark (Vec<Fr>, Vec<Fr>) as
    (inputs, outputs) (entry.rs:55-59). The circuit is compiled into the
    contract (the reference hardcodes the mini layers); `circuit=` overrides."""
    curve = get_curve(curve_name)
    from .schemes.libra.circuit import Circuit
    from .schemes.libra.zk_linear_gkr import Parameters, ZKLinearGKRProof

    try:
        params = ark_decode(curve, vk_cell, Parameters, device)
        proof = ark_decode(curve, proof_cell, ZKLinearGKRProof, device)
        inputs, outputs = ark_decode(
            curve, publics_cell, Tup(Vec(FR), Vec(FR))
        )
    except (ValueError, EOFError, IndexError, TypeError):
        return ERR_ENCODING
    if circuit is None:
        circuit = Circuit(*MINI_GKR_SIZE, list(MINI_GKR_LAYERS))
    try:
        ok = proof.verify(
            params, circuit, list(outputs), list(inputs),
            circuit.circuit_to_hash(curve), params.param_to_hash(), device=device,
        )
    except (ValueError, AssertionError, ZeroDivisionError, IndexError):
        return ERR_VERIFY
    return OK if ok else ERR_VERIFY


def mini_hyrax_zk_linear_gkr_verifier(
    curve_name: str, vk_cell: bytes, proof_cell: bytes, publics_cell: bytes,
    circuit=None, device="cuda",
) -> int:
    """mini_hyrax_zk_linear_gkr_verifier: vk cell = ark Parameters, proof
    cell = ark HyraxProof, publics cell = ark (Vec<Vec<Fr>>, Vec<Vec<Fr>>)
    as per-instance (inputs, outputs) (entry.rs:55-59)."""
    curve = get_curve(curve_name)
    from .schemes.hyrax.circuit import Circuit
    from .schemes.hyrax.hyrax_proof import HyraxProof
    from .schemes.hyrax.params import Parameters

    try:
        params = ark_decode(curve, vk_cell, Parameters, device)
        proof = ark_decode(curve, proof_cell, HyraxProof, device)
        inputs, outputs = ark_decode(
            curve, publics_cell, Tup(Vec(Vec(FR)), Vec(Vec(FR)))
        )
    except (ValueError, EOFError, IndexError, TypeError):
        return ERR_ENCODING
    if circuit is None:
        circuit = Circuit(*MINI_GKR_SIZE, list(MINI_GKR_LAYERS))
    try:
        ok = proof.verify(
            params, [list(o) for o in outputs], [list(i) for i in inputs],
            circuit, circuit.circuit_to_hash(curve), params.param_to_hash(), device=device,
        )
    except (ValueError, AssertionError, ZeroDivisionError, IndexError):
        return ERR_VERIFY
    return OK if ok else ERR_VERIFY

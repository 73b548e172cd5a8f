# Copied from ckb_zkp_tpu/schemes/plonk/serialize.py (host ints and bytes only): the port keeps its own copy.
"""PLONK proof / verifier-key (de)serialization, ark-0.2 wire format.

Mirrors the reference derives (ckb-zkp plonk/src/data_structures.rs:
21-45): VerifierKey{info, comms, labels, rk} and Proof{commitments,
evaluations, pc_proof}, with PC = MarlinKZG10 (lib.rs:306-307). Primitive
layouts:

- `IndexInfo` has a manual impl (ahp/indexer/mod.rs:36-46): n (usize -> u64
  LE), ks[0..4] (Fr), then the evaluation domain.
- `GeneralEvaluationDomain` (ark-poly 0.2): u8 enum tag (0 = Radix2) +
  `Radix2EvaluationDomain` derived fields in order: size u64,
  log_size_of_group u32, size_as_field_element, size_inv, group_gen,
  group_gen_inv, generator_inv (all Fr).
- `Vec<String>`: u64 count, each string u64 byte-length + UTF-8 bytes.
- `BatchLCProof{proof: Vec<kzg10::Proof>, evals: Option<Vec<F>>}`
  (ark-poly-commit 0.2); `open_combinations` emits evals = None.

The commitment/label order is the indexer's poly order (INDEX_LABELS).
"""

from __future__ import annotations

import io

from ...serialize.ark import FieldCodec, read_u64, write_u64
from ...serialize.ark_schemes import FR, ArkSchemeCodec, S, Vec
from .. import kzg10
from ..marlin import pc
from .plonk import INDEX_LABELS, IndexInfo, Proof, VerifierKey


def _write_domain(buf: io.BytesIO, fc: FieldCodec, spec, n: int) -> None:
    """Radix2EvaluationDomain in ark-poly-0.2 derived field order."""
    p = spec.modulus
    buf.write(b"\x00")  # GeneralEvaluationDomain::Radix2
    write_u64(buf, n)
    buf.write((n.bit_length() - 1).to_bytes(4, "little"))  # log_size u32
    buf.write(fc.to_bytes(n % p))  # size_as_field_element
    buf.write(fc.to_bytes(pow(n, -1, p)))  # size_inv
    g = spec.root_of_unity(n)
    buf.write(fc.to_bytes(g))  # group_gen
    buf.write(fc.to_bytes(pow(g, -1, p)))  # group_gen_inv
    buf.write(fc.to_bytes(pow(spec.generator, -1, p)))  # generator_inv


def _read_domain(buf: io.BytesIO, fc: FieldCodec, spec) -> int:
    tag = buf.read(1)
    if tag != b"\x00":
        raise ValueError("unsupported evaluation-domain variant")
    n = read_u64(buf)
    log = int.from_bytes(buf.read(4), "little")
    fields = [fc.read(buf) for _ in range(5)]
    p = spec.modulus
    if (
        log != n.bit_length() - 1
        or fields[0] != n % p
        or fields[2] != spec.root_of_unity(n)
    ):
        raise ValueError("inconsistent evaluation domain")
    return n


def vk_to_bytes(curve, vk: VerifierKey) -> bytes:
    codec = ArkSchemeCodec(curve)
    fc = FieldCodec(curve.fr)
    buf = io.BytesIO()
    write_u64(buf, vk.info.n)
    for k in vk.info.ks:
        buf.write(fc.to_bytes(k))
    _write_domain(buf, fc, curve.fr, vk.info.n)
    buf.write(
        codec.encode(
            [vk.comms[l] for l in INDEX_LABELS], Vec(S(pc.Commitment))
        )
    )
    write_u64(buf, len(INDEX_LABELS))
    for label in INDEX_LABELS:
        raw = label.encode()
        write_u64(buf, len(raw))
        buf.write(raw)
    buf.write(codec.encode(vk.rk, S(pc.VerifierKey)))
    return buf.getvalue()


def vk_from_bytes(curve, data: bytes) -> VerifierKey:
    codec = ArkSchemeCodec(curve)
    fc = FieldCodec(curve.fr)
    buf = io.BytesIO(data)
    n = read_u64(buf)
    ks = [fc.read(buf) for _ in range(4)]
    dom_n = _read_domain(buf, fc, curve.fr)
    if dom_n != n:
        raise ValueError("domain size mismatch")
    comms = codec._read(buf, Vec(S(pc.Commitment)))
    nlabels = read_u64(buf)
    labels = []
    for _ in range(nlabels):
        ln = read_u64(buf)
        labels.append(buf.read(ln).decode())
    if labels != INDEX_LABELS:
        raise ValueError("unexpected index poly labels")
    rk = codec._read(buf, S(pc.VerifierKey))
    if buf.read(1):
        raise ValueError("trailing bytes")
    return VerifierKey(
        curve=curve,
        comms=dict(zip(INDEX_LABELS, comms)),
        rk=rk,
        info=IndexInfo(n=n, ks=ks),
    )


def proof_to_bytes(curve, proof: Proof) -> bytes:
    codec = ArkSchemeCodec(curve)
    buf = io.BytesIO()
    buf.write(
        codec.encode(proof.commitments, Vec(Vec(S(pc.Commitment))))
    )
    buf.write(codec.encode(proof.evaluations, Vec(FR)))
    # BatchLCProof { proof, evals: None }
    buf.write(codec.encode(proof.pc_proofs, Vec(S(kzg10.OpenProof))))
    buf.write(b"\x00")
    return buf.getvalue()


def proof_from_bytes(curve, data: bytes) -> Proof:
    codec = ArkSchemeCodec(curve)
    buf = io.BytesIO(data)
    commitments = codec._read(buf, Vec(Vec(S(pc.Commitment))))
    evaluations = codec._read(buf, Vec(FR))
    pc_proofs = codec._read(buf, Vec(S(kzg10.OpenProof)))
    evals_tag = buf.read(1)
    if evals_tag != b"\x00":
        raise ValueError("unexpected BatchLCProof.evals payload")
    if buf.read(1):
        raise ValueError("trailing bytes")
    return Proof(
        commitments=commitments, evaluations=evaluations, pc_proofs=pc_proofs
    )

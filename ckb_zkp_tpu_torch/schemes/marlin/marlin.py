"""Marlin top level: universal_setup / index / prove / verify.

Port of the reference's `schemes/marlin/marlin.py` (ckb-zkp
marlin/src/lib.rs:57-250 and data_structures.rs:11-47). `universal_setup`
takes the device; `index` takes it from the SRS's tensors and the keys
carry it: the prover's HDomains and commitments and the verifier's
HDomains run on it.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import torch

from ...host.pairing import PairingCurve
from ...r1cs import ConstraintSynthesizer
from ...serialize.tobytes import frs_bytes
from ..errors import SchemeError
from ..groth16.prover import Stages
from . import ahp, pc
from .fs_rng import FiatShamirRng


@dataclass
class IndexVerifierKey:
    curve: PairingCurve
    index_info: ahp.IndexInfo
    index_comms: list[pc.Commitment]
    verifier_key: pc.VerifierKey
    device: torch.device

    def to_bytes(self) -> bytes:
        out = self.index_info.to_bytes()
        for c in self.index_comms:
            out += pc.commitment_bytes(self.curve, c)
        out += self.verifier_key.to_bytes()
        return out


@dataclass
class IndexProverKey:
    index: ahp.Index
    index_rands: list[pc.Randomness]
    index_verifier_key: IndexVerifierKey
    committer_key: pc.CommitterKey


@dataclass
class Proof:
    commitments: list[list[pc.Commitment]]
    evaluations: list[int]
    opening_proofs: list


def universal_setup(
    curve: PairingCurve, max_degree: int, rng: random.Random, device="cuda"
) -> pc.UniversalParams:
    n = 1
    while n < max(1, max_degree):
        n *= 2
    return pc.setup(curve, n, rng, device)


def index(srs: pc.UniversalParams, circuit: ConstraintSynthesizer,
          timings: dict | None = None):
    """`timings`, when given, receives the seconds of the AHP indexer and
    of the index commitments."""
    curve = srs.curve
    device = srs.powers_of_g[0].device
    st = Stages(timings, device)
    idx = ahp.index(curve.fr, circuit, device)
    if srs.max_degree < idx.max_degree():
        raise SchemeError("index too large for srs")
    st.mark("ahp")
    ck, vk = pc.trim(srs, idx.max_degree())
    index_comms_labeled, index_rands = pc.commit(ck, idx.iter_polys(), None)
    st.mark("commit")
    ivk = IndexVerifierKey(
        curve=curve,
        index_info=idx.index_info,
        index_comms=[c.commitment for c in index_comms_labeled],
        verifier_key=vk,
        device=device,
    )
    ipk = IndexProverKey(
        index=idx, index_rands=index_rands, index_verifier_key=ivk, committer_key=ck
    )
    return ipk, ivk


def _comms_bytes(curve, comms: list[pc.Commitment]) -> bytes:
    return b"".join(pc.commitment_bytes(curve, c) for c in comms)


def create_random_proof(
    ipk: IndexProverKey, circuit: ConstraintSynthesizer, zk_rng: random.Random,
    timings: dict | None = None,
) -> Proof:
    """`timings`, when given, receives the seconds of each stage: the
    synthesis, each round's AHP and commitments, the evaluations and the
    batch opening."""
    curve = ipk.index_verifier_key.curve
    p = curve.fr.modulus
    st = Stages(timings, ipk.index.device)
    state = ahp.prover_init(ipk.index, circuit)
    st.mark("init")
    public_input = state.public_input()
    fs_rng = FiatShamirRng(
        ipk.index_verifier_key.to_bytes() + frs_bytes(curve, public_input)
    )
    # round 1
    state, first_oracles = ahp.prover_first_round(state, zk_rng)
    st.mark("round1_ahp")
    first_comms, first_rands = pc.commit(ipk.committer_key, first_oracles, zk_rng)
    st.mark("round1_commit")
    fs_rng.absorb(_comms_bytes(curve, [c.commitment for c in first_comms]))
    vstate, first_msg = ahp.verifier_first_round(
        curve.fr, ipk.index_verifier_key.index_info, fs_rng, ipk.index.device
    )
    # round 2
    state, second_oracles = ahp.prover_second_round(state, first_msg)
    st.mark("round2_ahp")
    second_comms, second_rands = pc.commit(ipk.committer_key, second_oracles, zk_rng)
    st.mark("round2_commit")
    fs_rng.absorb(_comms_bytes(curve, [c.commitment for c in second_comms]))
    vstate, second_msg = ahp.verifier_second_round(vstate, fs_rng, p)
    # round 3
    third_oracles = ahp.prover_third_round(state, second_msg)
    st.mark("round3_ahp")
    third_comms, third_rands = pc.commit(ipk.committer_key, third_oracles, zk_rng)
    st.mark("round3_commit")
    fs_rng.absorb(_comms_bytes(curve, [c.commitment for c in third_comms]))
    vstate = ahp.verifier_third_round(vstate, fs_rng, p)

    polynomials = (
        ipk.index.iter_polys() + first_oracles + second_oracles + third_oracles
    )
    randomnesses = ipk.index_rands + first_rands + second_rands + third_rands
    query_set = ahp.verifier_query_set(vstate)
    evaluations = []
    for label, point in sorted(query_set):
        poly = next(q for q in polynomials if q.label == label)
        evaluations.append(poly.evaluate(point, p))
    fs_rng.absorb(frs_bytes(curve, evaluations))
    opening_challenge = fs_rng.rand_u128() % p
    st.mark("evaluations")

    opening_proofs = pc.batch_open(
        ipk.committer_key, polynomials, query_set, opening_challenge, randomnesses
    )
    st.mark("batch_open")
    return Proof(
        commitments=[
            [c.commitment for c in first_comms],
            [c.commitment for c in second_comms],
            [c.commitment for c in third_comms],
        ],
        evaluations=evaluations,
        opening_proofs=opening_proofs,
    )


def verify_proof(
    ivk: IndexVerifierKey, proof: Proof, public_input: list[int]
) -> bool:
    curve = ivk.curve
    p = curve.fr.modulus
    fs_rng = FiatShamirRng(ivk.to_bytes() + frs_bytes(curve, public_input))
    fs_rng.absorb(_comms_bytes(curve, proof.commitments[0]))
    vstate, _ = ahp.verifier_first_round(curve.fr, ivk.index_info, fs_rng, ivk.device)
    fs_rng.absorb(_comms_bytes(curve, proof.commitments[1]))
    vstate, _ = ahp.verifier_second_round(vstate, fs_rng, p)
    fs_rng.absorb(_comms_bytes(curve, proof.commitments[2]))
    vstate = ahp.verifier_third_round(vstate, fs_rng, p)

    query_set = ahp.verifier_query_set(vstate)
    fs_rng.absorb(frs_bytes(curve, proof.evaluations))
    opening_challenge = fs_rng.rand_u128() % p

    degree_bounds = (
        [None] * len(ivk.index_comms)
        + ahp.first_round_degree_bounds(ivk.index_info)
        + ahp.second_round_degree_bounds(ivk.index_info)
        + ahp.third_round_degree_bounds(ivk.index_info)
    )
    all_comms = (
        ivk.index_comms
        + proof.commitments[0]
        + proof.commitments[1]
        + proof.commitments[2]
    )
    labeled = [
        pc.LabeledCommitment(label, comm, bound)
        for (comm, label), bound in zip(
            zip(all_comms, ahp.polynomial_labels()), degree_bounds
        )
    ]
    evaluations = {
        (label, point): e
        for (label, point), e in zip(sorted(query_set), proof.evaluations)
    }
    if not ahp.verifier_equality_check(curve.fr, public_input, evaluations, vstate):
        return False
    return pc.batch_check(
        ivk.verifier_key,
        labeled,
        query_set,
        evaluations,
        proof.opening_proofs,
        opening_challenge,
    )

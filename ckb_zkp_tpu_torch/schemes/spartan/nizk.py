"""Spartan NIZK: setup / prove / verify.

Port of the reference's `schemes/spartan/nizk.py`, word for word but for
the device (parity: ckb-zkp spartan/src/{r1cs.rs, prover.rs:200-1061,
verify.rs:25-489} — identical transcript schedule, zero-knowledge
sumchecks with per-round commitment + sigma opening proofs, and the
bullet-IPA witness opening against the sqrt-packing commitment).

`create_nizk_proof` and `verify_nizk_proof` take `device` (default
"cuda"), which goes down to the Pedersen commitments
(`common.poly_commit_vec`, device MSMs of FIXED_BASE_MSM_MIN scalars or
more) and to the sumchecks (`DeviceSumcheck` at tables of
DEVICE_SUMCHECK_MIN or more). The setup is host ints only.
`create_nizk_proof` also takes a `timings` dict, which receives the
seconds of its stages.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ...host.pairing import PairingCurve
from ...r1cs import ConstraintSystem, ConstraintSynthesizer, SynthesisMode
from ...serialize.tobytes import fr_bytes, point_bytes
from ...transcript import Transcript
from ..groth16.prover import Stages
from .common import (
    InnerProductProof,
    MultiCommitmentParameters,
    NizkParameters,
    R1CSSatisfiedParameters,
    bullet_inner_product_proof,
    bullet_inner_product_verify,
    challenge_fr,
    packing_poly_commit,
    poly_commit_vec,
    r1cs_satisfied_parameters,
)
from .polynomial import (
    combine_with_n,
    combine_with_r,
    eval_eq,
    eval_eq_x_y,
    evaluate_matrix_vec,
    evaluate_matrix_vec_col,
    evaluate_mle,
    sparse_evaluate_value,
)

Entry = tuple[int, str, int]  # (coeff, 'A'|'I', index)


@dataclass
class R1CSInstance:
    curve: PairingCurve
    num_inputs: int
    num_aux: int
    num_constraints: int
    a_matrix: list[list[Entry]]
    b_matrix: list[list[Entry]]
    c_matrix: list[list[Entry]]

    def r1cs_to_hash(self) -> int:
        """The reference's messages in its order: a matrix's entries are
        queued at once (`Transcript.append_messages`), each distinct
        coefficient's bytes made once."""
        curve = self.curve
        t = Transcript(b"Spartan r1cs")
        t.append_u64(b"num_inputs", self.num_inputs)
        t.append_u64(b"num_aux", self.num_aux)
        t.append_u64(b"num_constraints", self.num_constraints)
        for name, m in (
            (b"a_matrix", self.a_matrix),
            (b"b_matrix", self.b_matrix),
            (b"c_matrix", self.c_matrix),
        ):
            index_label = {"A": name + b"_index_aux", "I": name + b"_index_input"}
            coeff_bytes: dict = {}
            labels, msgs = [], []
            for row in m:
                for coeff, kind, idx in row:
                    c = coeff_bytes.get(coeff)
                    if c is None:
                        c = coeff_bytes[coeff] = fr_bytes(curve, coeff)
                    labels += (name, index_label.get(kind, index_label["I"]))
                    msgs += (c, int(idx).to_bytes(8, "little"))
            t.append_messages(labels, msgs)
        return challenge_fr(curve, t, b"challenge_nextround")


def generate_r1cs(curve: PairingCurve, circuit: ConstraintSynthesizer) -> R1CSInstance:
    p = curve.fr.modulus
    cs = ConstraintSystem(SynthesisMode.SETUP)
    circuit.generate_constraints(cs)

    def rows(which: int):
        out = []
        for con in cs.constraints:
            row = []
            for v, coeff in con[1 + which].terms.items():
                c = coeff % p
                if c or True:  # reference keeps explicit zero coeffs too
                    row.append((c, v.kind, v.index))
            out.append(row)
        return out

    a, b, c = rows(0), rows(1), rows(2)
    nc = len(cs.constraints)
    nc_pad = 1 if nc == 0 else 1 << (nc - 1).bit_length()
    for _ in range(nc_pad - nc):
        a.append([])
        b.append([])
        c.append([])
    return R1CSInstance(
        curve=curve,
        num_inputs=cs.num_inputs,
        num_aux=cs.num_aux,
        num_constraints=nc_pad,
        a_matrix=a,
        b_matrix=b,
        c_matrix=c,
    )


def generate_setup_parameters(
    curve: PairingCurve, rng: random.Random, num_aux: int, num_inputs: int, device="cuda"
) -> NizkParameters:
    """The generators' products run on `device` where the list is long
    enough (`common.poly_commitment_parameters`)."""
    return NizkParameters(
        r1cs_satisfied_parameters(curve, rng, num_aux, num_inputs, device)
    )


def params_to_hash(curve: PairingCurve, params: NizkParameters) -> int:
    t = Transcript(b"Spartan nizk params")
    sp = params.r1cs_satisfied_params
    t.append_u64(b"r1cs_satisfied_params_n", sp.n)
    t.append_u64(b"r1cs_satisfied_params_pc_params_n", sp.pc_params.n)

    def absorb_mc(mc: MultiCommitmentParameters):
        t.append_u64(b"MultiCommitmentParameters_n", mc.n)
        t.append_message(b"MultiCommitmentParameters_h", point_bytes(curve, mc.h))
        for g in mc.generators:
            t.append_message(
                b"MultiCommitmentParameters_generators", point_bytes(curve, g)
            )

    absorb_mc(sp.pc_params.gen_n)
    absorb_mc(sp.pc_params.gen_1)
    absorb_mc(sp.sc_params.gen_1)
    absorb_mc(sp.sc_params.gen_3)
    absorb_mc(sp.sc_params.gen_4)
    return challenge_fr(curve, t, b"challenge_nextround")


# ---------------- proof data structures ----------------
@dataclass
class SumCheckEvalProof:
    d_commit: object
    dot_cd_commit: object
    z: list[int]
    z_delta: int
    z_beta: int


@dataclass
class SumCheckProof:
    comm_polys: list
    comm_evals: list
    proofs: list[SumCheckEvalProof]


@dataclass
class KnowledgeProof:
    t_commit: object
    z1: int
    z2: int


@dataclass
class ProductProof:
    commit_alpha: object
    commit_beta: object
    commit_delta: object
    z: list[int]


@dataclass
class EqProof:
    alpha: object
    z: int


@dataclass
class DotProductProof:
    inner_product_proof: InnerProductProof
    delta: object
    beta: object
    z1: int
    z2: int


@dataclass
class KnowledgeProductCommit:
    va_commit: object
    vb_commit: object
    vc_commit: object
    prod_commit: object


@dataclass
class KnowledgeProductProof:
    knowledge_proof: KnowledgeProof
    product_proof: ProductProof


@dataclass
class R1CSSatProof:
    commit_witness: list
    proof_one: SumCheckProof
    proof_two: SumCheckProof
    w_ry: int
    product_proof: DotProductProof
    knowledge_product_commit: KnowledgeProductCommit
    knowledge_product_proof: KnowledgeProductProof
    sc1_eq_proof: EqProof
    sc2_eq_proof: EqProof
    commit_ry: object


@dataclass
class NIZKProof:
    r1cs_satisfied_proof: R1CSSatProof
    r: tuple[list[int], list[int]]


# ---------------- prover ----------------
def create_nizk_proof(
    curve: PairingCurve,
    params: NizkParameters,
    r1cs: R1CSInstance,
    circuit: ConstraintSynthesizer,
    r1cs_hash: int,
    params_hash: int,
    rng: random.Random,
    device="cuda",
    timings: dict | None = None,
) -> NIZKProof:
    """`timings`, when given, receives the seconds of the prover's stages
    (`r1cs_satisfied_prover`)."""
    transcript = Transcript(b"Spartan NIZK proof")
    transcript.append_message(b"r1cs_hash", fr_bytes(curve, r1cs_hash))
    transcript.append_message(b"params_hash", fr_bytes(curve, params_hash))
    proof, (rx, ry) = r1cs_satisfied_prover(
        curve, params.r1cs_satisfied_params, r1cs, circuit, rng, transcript, device=device,
        timings=timings,
    )
    return NIZKProof(proof, (rx, ry))


def verify_nizk_proof(
    curve: PairingCurve,
    params: NizkParameters,
    r1cs: R1CSInstance,
    inputs: list[int],
    proof: NIZKProof,
    r1cs_hash: int,
    params_hash: int, device="cuda",
) -> bool:
    p = curve.fr.modulus
    transcript = Transcript(b"Spartan NIZK proof")
    transcript.append_message(b"r1cs_hash", fr_bytes(curve, r1cs_hash))
    transcript.append_message(b"params_hash", fr_bytes(curve, params_hash))
    rx, ry = proof.r
    eval_a = evaluate_mle(r1cs.a_matrix, rx, ry, p)
    eval_b = evaluate_mle(r1cs.b_matrix, rx, ry, p)
    eval_c = evaluate_mle(r1cs.c_matrix, rx, ry, p)
    ok, _, _ = r1cs_satisfied_verify(
        curve,
        params.r1cs_satisfied_params,
        r1cs,
        inputs,
        proof.r1cs_satisfied_proof,
        (eval_a, eval_b, eval_c),
        transcript, device=device,
    )
    return ok


def r1cs_satisfied_prover(
    curve, params: R1CSSatisfiedParameters, r1cs: R1CSInstance, circuit, rng, transcript,
    device="cuda", timings: dict | None = None,
):
    """`timings`, when given, receives the seconds of the stages:
    synthesize, witness_commit, sumcheck1 (with the matrix-vector products
    and eq(tau)), sigma_proofs (knowledge, product and eq proofs),
    sumcheck2 (with the column evaluations) and inner_product_proof (the
    witness opening and the last eq proof)."""
    st = Stages(timings, device)
    p = curve.fr.modulus
    cs = ConstraintSystem(SynthesisMode.PROVE)
    circuit.generate_constraints(cs)
    input_assignment = [int(v) % p for v in cs.input_values]
    aux_assignment = [int(v) % p for v in cs.aux_values]
    t = max(r1cs.num_aux, r1cs.num_inputs)
    t = 1 if t == 0 else 1 << (t - 1).bit_length()
    aux_assignment += [0] * (t - len(aux_assignment))
    input_assignment += [0] * (t - len(input_assignment))
    z = aux_assignment + input_assignment
    st.mark("synthesize")

    transcript.append_message(b"r1cs_input", b"".join(fr_bytes(curve, x) for x in input_assignment))

    pc, sc = params.pc_params, params.sc_params
    commit_witness, witness_blinds = packing_poly_commit(
        curve, pc.gen_n.generators, aux_assignment, pc.gen_n.h, rng, True, device=device
    )
    transcript.append_message(
        b"poly_commitment", b"".join(point_bytes(curve, c) for c in commit_witness)
    )
    st.mark("witness_commit")
    n = r1cs.num_constraints
    num_rounds_x = n.bit_length() - 1
    num_rounds_y = (t.bit_length() - 1) + 1
    tau = [challenge_fr(curve, transcript, b"challenge_tau") for _ in range(num_rounds_x)]

    eq_tau = eval_eq(tau, p)
    ma = evaluate_matrix_vec(r1cs.a_matrix, z, p)
    mb = evaluate_matrix_vec(r1cs.b_matrix, z, p)
    mc = evaluate_matrix_vec(r1cs.c_matrix, z, p)

    proof_sc1, rx, (v_a, v_b, v_c, eq_tau_rx), blinds_eval1 = sum_check_phase_one(
        curve, num_rounds_x, sc, 0, ma, mb, mc, eq_tau, rng, transcript, device=device
    )
    st.mark("sumcheck1")
    prod = v_a * v_b % p
    blind_a, blind_b, blind_c, blind_prod = (rng.randrange(p) for _ in range(4))
    vc_proof, vc_commit = knowledge_proof(
        curve, sc.gen_1, v_c, blind_c, rng, transcript, device=device
    )
    prod_proof_, va_commit, vb_commit, prod_commit = product_proof(
        curve, sc.gen_1, v_a, blind_a, v_b, blind_b, prod, blind_prod, rng, transcript,
        device=device
    )
    for lbl, cm in (
        (b"comm_Az_claim", va_commit),
        (b"comm_Bz_claim", vb_commit),
        (b"comm_Cz_claim", vc_commit),
        (b"comm_prod_Az_Bz_claims", prod_commit),
    ):
        transcript.append_message(lbl, point_bytes(curve, cm))

    blind_claim_sc1 = eq_tau_rx * (blind_prod - blind_c) % p
    claim_sc1 = eq_tau_rx * (prod - v_c) % p
    sc1_eq = eq_proof(
        curve, sc.gen_1, claim_sc1, blind_claim_sc1, claim_sc1, blinds_eval1, rng, transcript,
        device=device
    )

    st.mark("sigma_proofs")
    r_a = challenge_fr(curve, transcript, b"challenege_Az")
    r_b = challenge_fr(curve, transcript, b"challenege_Bz")
    r_c = challenge_fr(curve, transcript, b"challenege_Cz")
    claim_phase2 = (v_a * r_a + v_b * r_b + v_c * r_c) % p
    claim_phase2_blind = (blind_a * r_a + blind_b * r_b + blind_c * r_c) % p

    evals_rx = eval_eq(rx, p)
    evals_a = evaluate_matrix_vec_col(r1cs.a_matrix, evals_rx, len(z), p)
    evals_b = evaluate_matrix_vec_col(r1cs.b_matrix, evals_rx, len(z), p)
    evals_c = evaluate_matrix_vec_col(r1cs.c_matrix, evals_rx, len(z), p)
    evals = [
        (r_a * evals_a[i] + r_b * evals_b[i] + r_c * evals_c[i]) % p
        for i in range(len(evals_a))
    ]
    proof_sc2, ry, (vs, vz), blinds_eval2 = sum_check_phase_two(
        curve, num_rounds_y, sc, claim_phase2, claim_phase2_blind, evals, list(z), rng, transcript,
        device=device
    )
    claim_sc2 = vs * vz % p
    st.mark("sumcheck2")

    eq_ry = eval_eq(ry[1:], p)
    eval_w_ry = sum(a * e % p for a, e in zip(aux_assignment, eq_ry)) % p
    blind_eval = rng.randrange(p)
    wproof, commit_ry = inner_product_proof_prover(
        curve, pc, aux_assignment, witness_blinds, ry[1:], blind_eval, eval_w_ry, rng, transcript,
        device=device
    )
    eval_at_zy_blind = (1 - ry[0]) * blind_eval % p
    eval_at_zy_blind_claim = eval_at_zy_blind * vs % p
    sc2_eq = eq_proof(
        curve, pc.gen_1, claim_sc2, eval_at_zy_blind_claim, claim_sc2, blinds_eval2, rng, transcript,
        device=device
    )
    proof = R1CSSatProof(
        commit_witness=commit_witness,
        proof_one=proof_sc1,
        proof_two=proof_sc2,
        w_ry=eval_w_ry,
        product_proof=wproof,
        knowledge_product_commit=KnowledgeProductCommit(
            va_commit, vb_commit, vc_commit, prod_commit
        ),
        knowledge_product_proof=KnowledgeProductProof(vc_proof, prod_proof_),
        sc1_eq_proof=sc1_eq,
        sc2_eq_proof=sc2_eq,
        commit_ry=commit_ry,
    )
    st.mark("inner_product_proof")
    return proof, (rx, ry)


def _poly_eval(coeffs: list[int], x: int, p: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def sum_check_phase_one(curve, num_rounds, sc, claim, pa, pb, pc_, peq, rng, transcript,
                        device="cuda"):
    p = curve.fr.modulus
    # large tables run the halving recurrence on device; only the 3 round
    # scalars cross to the host (ops/sumcheck.py, SURVEY hard part #4)
    from ...ops.sumcheck import DEVICE_SUMCHECK_MIN, DeviceSumcheck

    dsc = DeviceSumcheck(curve.fr, device=device) if len(peq) >= DEVICE_SUMCHECK_MIN else None
    if dsc is not None:
        pa, pb, pc_, peq = (dsc.encode_table(v) for v in (pa, pb, pc_, peq))
    blinds_poly = [rng.randrange(p) for _ in range(num_rounds)]
    blinds_evals = [rng.randrange(p) for _ in range(num_rounds)]
    commit_eval = poly_commit_vec(curve, sc.gen_1.generators, [claim], sc.gen_1.h, 0, device=device)
    six_inv = pow(6, -1, p)
    two_inv = pow(2, -1, p)
    rx, comm_polys, comm_evals, proofs = [], [], [], []
    blind_poly_eval = 0
    for i in range(num_rounds):
        if dsc is not None:
            eval_0, eval_2, eval_3 = dsc.cubic_round(pa, pb, pc_, peq)
        else:
            size = len(peq) // 2
            eval_0 = sum(peq[j] * ((pa[j] * pb[j] - pc_[j]) % p) % p for j in range(size)) % p
            pa2, pb2, pc2, peq2 = (combine_with_n(v, 2, p) for v in (pa, pb, pc_, peq))
            eval_2 = sum(peq2[j] * ((pa2[j] * pb2[j] - pc2[j]) % p) % p for j in range(size)) % p
            pa3, pb3, pc3, peq3 = (combine_with_n(v, 3, p) for v in (pa, pb, pc_, peq))
            eval_3 = sum(peq3[j] * ((pa3[j] * pb3[j] - pc3[j]) % p) % p for j in range(size)) % p
        eval_1 = (claim - eval_0) % p
        a_c = (-eval_0 + 3 * eval_1 - 3 * eval_2 + eval_3) * six_inv % p
        b_c = (2 * eval_0 - 5 * eval_1 + 4 * eval_2 - eval_3) * two_inv % p
        c_c = (eval_1 - eval_0 - a_c - b_c) % p
        d_c = eval_0 % p
        poly = [d_c, c_c, b_c, a_c]
        commit_poly = poly_commit_vec(
            curve, sc.gen_4.generators, poly, sc.gen_4.h, blinds_poly[i], device=device
        )
        transcript.append_message(b"comm_poly", point_bytes(curve, commit_poly))
        r_i = challenge_fr(curve, transcript, b"challenge_nextround")
        if dsc is not None:
            pa, pb, pc_, peq = (dsc.bind(v, r_i) for v in (pa, pb, pc_, peq))
        else:
            pa, pb, pc_, peq = (combine_with_r(v, r_i, p) for v in (pa, pb, pc_, peq))
        transcript.append_message(b"comm_claim_per_round", point_bytes(curve, commit_eval))
        eval_ri = _poly_eval(poly, r_i, p)
        commit_eval = poly_commit_vec(
            curve, sc.gen_1.generators, [eval_ri], sc.gen_1.h, blinds_evals[i], device=device
        )
        transcript.append_message(b"comm_eval", point_bytes(curve, commit_eval))
        blind_claim = blinds_evals[i - 1] if i > 0 else 0
        prf = sum_check_eval_prover(
            curve, sc.gen_1, sc.gen_4, poly, commit_poly, blinds_poly[i],
            claim, blind_claim, eval_ri, blinds_evals[i], 4, r_i, rng, transcript, device=device,
        )
        rx.append(r_i)
        comm_polys.append(commit_poly)
        comm_evals.append(commit_eval)
        proofs.append(prf)
        blind_poly_eval = blinds_evals[i]
        claim = eval_ri
    if dsc is not None:
        values = tuple(dsc.first(v) for v in (pa, pb, pc_, peq))
    else:
        values = (pa[0], pb[0], pc_[0], peq[0])
    return SumCheckProof(comm_polys, comm_evals, proofs), rx, values, blind_poly_eval


def sum_check_phase_two(curve, num_rounds, sc, claim, blind_claim0, pabc, pz, rng, transcript,
                        device="cuda"):
    p = curve.fr.modulus
    from ...ops.sumcheck import DEVICE_SUMCHECK_MIN, DeviceSumcheck

    dsc = DeviceSumcheck(curve.fr, device=device) if len(pz) >= DEVICE_SUMCHECK_MIN else None
    if dsc is not None:
        pabc = dsc.encode_table(pabc)
        pz = dsc.encode_table(pz)
    blinds_poly = [rng.randrange(p) for _ in range(num_rounds)]
    blinds_evals = [rng.randrange(p) for _ in range(num_rounds)]
    commit_claim = poly_commit_vec(
        curve, sc.gen_1.generators, [claim], sc.gen_1.h, blind_claim0, device=device
    )
    two_inv = pow(2, -1, p)
    ry, comm_polys, comm_evals, proofs = [], [], [], []
    blind_poly_eval = 0
    for i in range(num_rounds):
        if dsc is not None:
            eval_0, eval_2 = dsc.quad_round(pabc, pz)
        else:
            size = len(pz) // 2
            eval_0 = sum(pz[j] * pabc[j] % p for j in range(size)) % p
            pabc2 = combine_with_n(pabc, 2, p)
            pz2 = combine_with_n(pz, 2, p)
            eval_2 = sum(pabc2[j] * pz2[j] % p for j in range(size)) % p
        eval_1 = (claim - eval_0) % p
        a_c = (eval_0 - 2 * eval_1 + eval_2) * two_inv % p
        c_c = eval_0 % p
        b_c = (eval_1 - a_c - c_c) % p
        poly = [c_c, b_c, a_c]
        commit_poly = poly_commit_vec(
            curve, sc.gen_3.generators, poly, sc.gen_3.h, blinds_poly[i], device=device
        )
        transcript.append_message(b"comm_poly", point_bytes(curve, commit_poly))
        r_j = challenge_fr(curve, transcript, b"challenge_nextround")
        eval_rj = _poly_eval(poly, r_j, p)
        commit_eval = poly_commit_vec(
            curve, sc.gen_1.generators, [eval_rj], sc.gen_1.h, blinds_evals[i], device=device
        )
        transcript.append_message(b"comm_claim_per_round", point_bytes(curve, commit_claim))
        transcript.append_message(b"comm_eval", point_bytes(curve, commit_eval))
        if dsc is not None:
            pabc = dsc.bind(pabc, r_j)
            pz = dsc.bind(pz, r_j)
        else:
            pabc = combine_with_r(pabc, r_j, p)
            pz = combine_with_r(pz, r_j, p)
        blind_claim = blinds_evals[i - 1] if i > 0 else blind_claim0
        prf = sum_check_eval_prover(
            curve, sc.gen_1, sc.gen_3, poly, commit_poly, blinds_poly[i],
            claim, blind_claim, eval_rj, blinds_evals[i], 3, r_j, rng, transcript, device=device,
        )
        ry.append(r_j)
        comm_polys.append(commit_poly)
        comm_evals.append(commit_eval)
        proofs.append(prf)
        blind_poly_eval = blinds_evals[i]
        claim = eval_rj
        commit_claim = commit_eval
    if dsc is not None:
        finals = (dsc.first(pabc), dsc.first(pz))
    else:
        finals = (pabc[0], pz[0])
    return SumCheckProof(comm_polys, comm_evals, proofs), ry, finals, blind_poly_eval


def sum_check_eval_prover(
    curve, gen_1, gen_n, poly, poly_commit, blind_poly, claim, blind_claim,
    eval_v, blind_eval, size, r, rng, transcript, device="cuda",
):
    p = curve.fr.modulus
    w = [challenge_fr(curve, transcript, b"combine_two_claims_to_one") for _ in range(2)]
    polynomial = list(poly) + [0] * (size - len(poly))
    claim_value = (w[0] * claim + w[1] * eval_v) % p
    blind = (w[0] * blind_claim + w[1] * blind_eval) % p
    coeffs = []
    rc = 1
    for _ in range(size):
        coeffs.append((w[0] + w[1] * rc) % p)
        rc = rc * r % p
    coeffs[0] = (coeffs[0] + w[0]) % p
    transcript.append_message(b"Cx", point_bytes(curve, poly_commit))
    commit_claim_value = poly_commit_vec(
        curve, gen_1.generators, [claim_value], gen_1.h, blind, device=device
    )
    transcript.append_message(b"Cy", point_bytes(curve, commit_claim_value))
    d_vec = [rng.randrange(p) for _ in range(size)]
    r_delta = rng.randrange(p)
    d_commit = poly_commit_vec(curve, gen_n.generators, d_vec, gen_n.h, r_delta, device=device)
    transcript.append_message(b"delta", point_bytes(curve, d_commit))
    r_beta = rng.randrange(p)
    dot_cd = sum(c * d % p for c, d in zip(coeffs, d_vec)) % p
    dot_cd_commit = poly_commit_vec(curve, gen_1.generators, [dot_cd], gen_1.h, r_beta,
                                    device=device)
    transcript.append_message(b"beta", point_bytes(curve, dot_cd_commit))
    c = challenge_fr(curve, transcript, b"c")
    z = [(c * polynomial[i] + d_vec[i]) % p for i in range(size)]
    return SumCheckEvalProof(
        d_commit=d_commit,
        dot_cd_commit=dot_cd_commit,
        z=z,
        z_delta=(c * blind_poly + r_delta) % p,
        z_beta=(c * blind + r_beta) % p,
    )


def knowledge_proof(curve, gen, claim, blind, rng, transcript, device="cuda"):
    p = curve.fr.modulus
    t1, t2 = rng.randrange(p), rng.randrange(p)
    claim_commit = poly_commit_vec(curve, gen.generators, [claim], gen.h, blind, device=device)
    transcript.append_message(b"C", point_bytes(curve, claim_commit))
    t_commit = poly_commit_vec(curve, gen.generators, [t1], gen.h, t2, device=device)
    transcript.append_message(b"alpha", point_bytes(curve, t_commit))
    c = challenge_fr(curve, transcript, b"c")
    return (
        KnowledgeProof(t_commit, (claim * c + t1) % p, (blind * c + t2) % p),
        claim_commit,
    )


def product_proof(curve, gen, ca, ba, cb, bb, prod, bprod, rng, transcript, device="cuda"):
    p = curve.fr.modulus
    b1, b2, b3, b4, b5 = (rng.randrange(p) for _ in range(5))
    a_commit = poly_commit_vec(curve, gen.generators, [ca], gen.h, ba, device=device)
    transcript.append_message(b"X", point_bytes(curve, a_commit))
    b_commit = poly_commit_vec(curve, gen.generators, [cb], gen.h, bb, device=device)
    transcript.append_message(b"Y", point_bytes(curve, b_commit))
    prod_commit = poly_commit_vec(curve, gen.generators, [prod], gen.h, bprod, device=device)
    transcript.append_message(b"Z", point_bytes(curve, prod_commit))
    commit_alpha = poly_commit_vec(curve, gen.generators, [b1], gen.h, b2, device=device)
    transcript.append_message(b"alpha", point_bytes(curve, commit_alpha))
    commit_beta = poly_commit_vec(curve, gen.generators, [b3], gen.h, b4, device=device)
    transcript.append_message(b"beta", point_bytes(curve, commit_beta))
    commit_delta = poly_commit_vec(curve, [a_commit], [b3], gen.h, b5, device=device)
    transcript.append_message(b"delta", point_bytes(curve, commit_delta))
    c = challenge_fr(curve, transcript, b"c")
    z = [
        (b1 + c * ca) % p,
        (b2 + c * ba) % p,
        (b3 + c * cb) % p,
        (b4 + c * bb) % p,
        (b5 + c * ((bprod - ba * cb) % p)) % p,
    ]
    return ProductProof(commit_alpha, commit_beta, commit_delta, z), a_commit, b_commit, prod_commit


def eq_proof(curve, gen, claim1, blind1, claim2, blind2, rng, transcript, device="cuda"):
    p = curve.fr.modulus
    r = rng.randrange(p)
    c1 = poly_commit_vec(curve, gen.generators, [claim1], gen.h, blind1, device=device)
    transcript.append_message(b"C1", point_bytes(curve, c1))
    c2 = poly_commit_vec(curve, gen.generators, [claim2], gen.h, blind2, device=device)
    transcript.append_message(b"C2", point_bytes(curve, c2))
    alpha = curve.g1.mul(gen.h, r)
    transcript.append_message(b"alpha", point_bytes(curve, alpha))
    c = challenge_fr(curve, transcript, b"c")
    return EqProof(alpha, (c * ((blind1 - blind2) % p) + r) % p)


def inner_product_proof_prover(
    curve, pc, poly, blind_poly, ry, ry_blind, eval_v, rng, transcript, device="cuda"
):
    p = curve.fr.modulus
    transcript.append_message(b"protocol-name", b"polynomial evaluation proof")
    n = len(poly)
    size = (n - 1).bit_length() if n > 1 else 0
    assert len(ry) == size
    l_size = 1 << (size // 2)
    r_size = 1 << (size - size // 2)
    blinds = list(blind_poly) if blind_poly else [0] * l_size
    l_eq = eval_eq(ry[: size // 2], p)
    r_eq = eval_eq(ry[size // 2 :], p)
    lz = [
        sum(l_eq[i] * poly[i * r_size + j] % p for i in range(l_size)) % p
        for j in range(r_size)
    ]
    lz_blind = sum(l_eq[i] * blinds[i] % p for i in range(l_size)) % p
    d = rng.randrange(p)
    r_delta = rng.randrange(p)
    r_beta = rng.randrange(p)
    blind_vec = [
        (rng.randrange(p), rng.randrange(p))
        for _ in range(max(0, (r_size - 1).bit_length()))
    ]
    commit_lz = poly_commit_vec(curve, pc.gen_n.generators, lz, pc.gen_n.h, lz_blind, device=device)
    transcript.append_message(b"Cx", point_bytes(curve, commit_lz))
    commit_ry = poly_commit_vec(curve, pc.gen_1.generators, [eval_v], pc.gen_1.h, ry_blind,
                                device=device)
    transcript.append_message(b"Cy", point_bytes(curve, commit_ry))
    blind_gamma = (lz_blind + ry_blind) % p
    ipp, a, b, g, blind_fin = bullet_inner_product_proof(
        curve, pc.gen_n.generators[:r_size], pc.gen_1.generators[0], pc.gen_n.h,
        lz, r_eq, blind_gamma, blind_vec, transcript,
    )
    delta = poly_commit_vec(curve, [g], [d], pc.gen_1.h, r_delta, device=device)
    transcript.append_message(b"delta", point_bytes(curve, delta))
    beta = poly_commit_vec(curve, pc.gen_1.generators, [d], pc.gen_1.h, r_beta, device=device)
    transcript.append_message(b"beta", point_bytes(curve, beta))
    c = challenge_fr(curve, transcript, b"challenge_tau")
    z1 = (d + c * (a * b % p)) % p
    z2 = (b * ((c * blind_fin + r_beta) % p) + r_delta) % p
    return DotProductProof(ipp, delta, beta, z1, z2), commit_ry


# ---------------- verifier ----------------
def r1cs_satisfied_verify(
    curve, params: R1CSSatisfiedParameters, r1cs: R1CSInstance, inputs, proof, matrix_evals, transcript,
    device="cuda"
):
    p = curve.fr.modulus
    g1 = curve.g1
    eval_a_r, eval_b_r, eval_c_r = matrix_evals
    t = max(r1cs.num_aux, r1cs.num_inputs)
    t = 1 if t == 0 else 1 << (t - 1).bit_length()
    num_rounds_x = r1cs.num_constraints.bit_length() - 1
    num_rounds_y = (t.bit_length() - 1) + 1
    public_inputs = [1] + [x % p for x in inputs] + [0] * (t - len(inputs) - 1)
    transcript.append_message(
        b"r1cs_input", b"".join(fr_bytes(curve, x) for x in public_inputs)
    )
    transcript.append_message(
        b"poly_commitment",
        b"".join(point_bytes(curve, c) for c in proof.commit_witness),
    )
    sc, pc = params.sc_params, params.pc_params
    tau = [challenge_fr(curve, transcript, b"challenge_tau") for _ in range(num_rounds_x)]

    commit_claim = poly_commit_vec(curve, sc.gen_1.generators, [0], sc.gen_1.h, 0, device=device)
    res = sum_check_verify(
        curve, sc.gen_1, sc.gen_4, proof.proof_one, commit_claim, 4, num_rounds_x, transcript,
        device=device
    )
    if res is None:
        return False, [], []
    rx, commit_eval_x = res

    kpc = proof.knowledge_product_commit
    if not knowledge_verify(
        curve, sc.gen_1, proof.knowledge_product_proof.knowledge_proof, kpc.vc_commit, transcript,
        device=device
    ):
        return False, [], []
    if not product_verify(
        curve, sc.gen_1, proof.knowledge_product_proof.product_proof,
        kpc.va_commit, kpc.vb_commit, kpc.prod_commit, transcript, device=device,
    ):
        return False, [], []
    for lbl, cm in (
        (b"comm_Az_claim", kpc.va_commit),
        (b"comm_Bz_claim", kpc.vb_commit),
        (b"comm_Cz_claim", kpc.vc_commit),
        (b"comm_prod_Az_Bz_claims", kpc.prod_commit),
    ):
        transcript.append_message(lbl, point_bytes(curve, cm))
    eval_rx_tau = eval_eq_x_y(rx, tau, p)
    claim_commit_phase_one = g1.mul(g1.sub(kpc.prod_commit, kpc.vc_commit), eval_rx_tau)
    if not eq_verify(
        curve, sc.gen_1, claim_commit_phase_one, commit_eval_x, proof.sc1_eq_proof, transcript
    ):
        return False, [], []

    r_a = challenge_fr(curve, transcript, b"challenege_Az")
    r_b = challenge_fr(curve, transcript, b"challenege_Bz")
    r_c = challenge_fr(curve, transcript, b"challenege_Cz")
    claim_commit_two = g1.add(
        g1.add(g1.mul(kpc.va_commit, r_a), g1.mul(kpc.vb_commit, r_b)),
        g1.mul(kpc.vc_commit, r_c),
    )
    res = sum_check_verify(
        curve, sc.gen_1, sc.gen_3, proof.proof_two, claim_commit_two, 3, num_rounds_y, transcript,
        device=device
    )
    if res is None:
        return False, [], []
    ry, commit_eval_y = res

    if not inner_product_verify(
        curve, pc, ry[1:], proof.commit_witness, proof.commit_ry, proof.product_proof, transcript,
        device=device
    ):
        return False, [], []

    padded = [1] + [x % p for x in inputs]
    padded += [0] * ((1 << len(ry[1:])) - len(padded))
    eval_input = sparse_evaluate_value(padded, ry[1:], p)
    commit_input = poly_commit_vec(curve, pc.gen_1.generators, [eval_input], pc.gen_1.h, 0,
                                   device=device)
    commit_eval_z = g1.add(
        g1.mul(proof.commit_ry, (1 - ry[0]) % p), g1.mul(commit_input, ry[0])
    )
    claim_commit_phase_two = g1.mul(
        commit_eval_z, (eval_a_r * r_a + eval_b_r * r_b + eval_c_r * r_c) % p
    )
    if not eq_verify(
        curve, pc.gen_1, claim_commit_phase_two, commit_eval_y, proof.sc2_eq_proof, transcript
    ):
        return False, [], []
    return True, rx, ry


def sum_check_verify(curve, gen_1, gen_n, proof, commit_claim, size, num_rounds, transcript,
                     device="cuda"):
    rx = []
    for i in range(num_rounds):
        commit_poly = proof.comm_polys[i]
        commit_eval = proof.comm_evals[i]
        prf = proof.proofs[i]
        transcript.append_message(b"comm_poly", point_bytes(curve, commit_poly))
        r_i = challenge_fr(curve, transcript, b"challenge_nextround")
        transcript.append_message(b"comm_claim_per_round", point_bytes(curve, commit_claim))
        transcript.append_message(b"comm_eval", point_bytes(curve, commit_eval))
        if not sum_check_eval_verify(
            curve, gen_1, gen_n, commit_poly, commit_eval, commit_claim, prf, r_i, size, transcript,
            device=device
        ):
            return None
        rx.append(r_i)
        commit_claim = commit_eval
    return rx, commit_claim


def sum_check_eval_verify(
    curve, gen_1, gen_n, commit_poly, commit_eval, commit_claim, proof, r, size, transcript,
    device="cuda"
):
    p = curve.fr.modulus
    g1 = curve.g1
    w = [challenge_fr(curve, transcript, b"combine_two_claims_to_one") for _ in range(2)]
    transcript.append_message(b"Cx", point_bytes(curve, commit_poly))
    commit_claim_value = g1.add(g1.mul(commit_claim, w[0]), g1.mul(commit_eval, w[1]))
    transcript.append_message(b"Cy", point_bytes(curve, commit_claim_value))
    transcript.append_message(b"delta", point_bytes(curve, proof.d_commit))
    transcript.append_message(b"beta", point_bytes(curve, proof.dot_cd_commit))
    c = challenge_fr(curve, transcript, b"c")
    coeffs = []
    rc = 1
    for _ in range(size):
        coeffs.append((w[0] + w[1] * rc) % p)
        rc = rc * r % p
    coeffs[0] = (coeffs[0] + w[0]) % p
    lhs = g1.add(g1.mul(commit_poly, c), proof.d_commit)
    rhs = poly_commit_vec(curve, gen_n.generators, proof.z, gen_n.h, proof.z_delta, device=device)
    if lhs != rhs:
        return False
    lhs = g1.add(g1.mul(commit_claim_value, c), proof.dot_cd_commit)
    s = sum(zi * ci % p for zi, ci in zip(proof.z, coeffs)) % p
    rhs = poly_commit_vec(curve, gen_1.generators, [s], gen_1.h, proof.z_beta, device=device)
    return lhs == rhs


def knowledge_verify(curve, gen, proof, commit, transcript, device="cuda"):
    g1 = curve.g1
    transcript.append_message(b"C", point_bytes(curve, commit))
    transcript.append_message(b"alpha", point_bytes(curve, proof.t_commit))
    c = challenge_fr(curve, transcript, b"c")
    lhs = poly_commit_vec(curve, gen.generators, [proof.z1], gen.h, proof.z2, device=device)
    rhs = g1.add(g1.mul(commit, c), proof.t_commit)
    return lhs == rhs


def product_verify(curve, gen, proof, va_commit, vb_commit, prod_commit, transcript, device="cuda"):
    p = curve.fr.modulus
    g1 = curve.g1
    z1, z2, z3, z4, z5 = proof.z
    transcript.append_message(b"X", point_bytes(curve, va_commit))
    transcript.append_message(b"Y", point_bytes(curve, vb_commit))
    transcript.append_message(b"Z", point_bytes(curve, prod_commit))
    transcript.append_message(b"alpha", point_bytes(curve, proof.commit_alpha))
    transcript.append_message(b"beta", point_bytes(curve, proof.commit_beta))
    transcript.append_message(b"delta", point_bytes(curve, proof.commit_delta))
    c = challenge_fr(curve, transcript, b"c")
    ok1 = g1.add(proof.commit_alpha, g1.mul(va_commit, c)) == poly_commit_vec(
        curve, gen.generators, [z1], gen.h, z2, device=device
    )
    ok2 = g1.add(proof.commit_beta, g1.mul(vb_commit, c)) == poly_commit_vec(
        curve, gen.generators, [z3], gen.h, z4, device=device
    )
    ok3 = g1.add(proof.commit_delta, g1.mul(prod_commit, c)) == poly_commit_vec(
        curve, [va_commit], [z3], gen.h, z5, device=device
    )
    return ok1 and ok2 and ok3


def eq_verify(curve, gen, commit1, commit2, proof, transcript):
    g1 = curve.g1
    transcript.append_message(b"C1", point_bytes(curve, commit1))
    transcript.append_message(b"C2", point_bytes(curve, commit2))
    transcript.append_message(b"alpha", point_bytes(curve, proof.alpha))
    c = challenge_fr(curve, transcript, b"c")
    commits = g1.sub(commit1, commit2)
    lhs = g1.mul(gen.h, proof.z)
    rhs = g1.add(g1.mul(commits, c), proof.alpha)
    return lhs == rhs


def inner_product_verify(curve, pc, ry, commits_witness, commit_ry, proof, transcript,
                         device="cuda"):
    p = curve.fr.modulus
    g1 = curve.g1
    transcript.append_message(b"protocol-name", b"polynomial evaluation proof")
    size = len(ry)
    l_eq = eval_eq(ry[: size // 2], p)
    r_eq = eval_eq(ry[size // 2 :], p)
    commit_lz = poly_commit_vec(curve, commits_witness, l_eq, pc.gen_1.h, 0, device=device)
    transcript.append_message(b"Cx", point_bytes(curve, commit_lz))
    transcript.append_message(b"Cy", point_bytes(curve, commit_ry))
    gamma = g1.add(commit_lz, commit_ry)
    r_size = 1 << (size - size // 2)
    b_s, g_hat, gamma_hat = bullet_inner_product_verify(
        curve, pc.gen_n.generators[:r_size], proof.inner_product_proof, gamma, r_eq, transcript
    )
    transcript.append_message(b"delta", point_bytes(curve, proof.delta))
    transcript.append_message(b"beta", point_bytes(curve, proof.beta))
    c = challenge_fr(curve, transcript, b"challenge_tau")
    lhs = g1.add(
        g1.mul(g1.add(g1.mul(gamma_hat, c), proof.beta), b_s), proof.delta
    )
    rhs = g1.add(
        g1.mul(g1.add(g_hat, g1.mul(pc.gen_1.generators[0], b_s)), proof.z1),
        g1.mul(pc.gen_1.h, proof.z2),
    )
    return lhs == rhs

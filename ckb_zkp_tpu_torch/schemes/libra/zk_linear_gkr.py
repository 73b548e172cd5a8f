"""Libra zero-knowledge linear GKR.

Port of the reference's `schemes/libra/zk_linear_gkr.py` (parity: ckb-zkp
libra/src/{libra_zk_linear_gkr.rs, sumcheck.rs:177-620, params.rs} —
per-layer zk sumchecks with committed round polynomials + per-round sigma
opening proofs, ProductProof/EqProof layer checks, and LogDotProduct
witness openings; it reuses the hyrax commitment suite, as the reference
duplicates commitment.rs between the two crates, and the challenge buffer
widths follow the hyrax file), word for word but for the device:
`Parameters.new` (Hyrax's) takes `device`; `ZKLinearGKRProof.prover` and
`verify` take `device` (default "cuda") down to the witness commitment,
`poly_commit_vec`, the sigma protocols and each layer's `DeviceLayer`;
`prover` also takes a `timings` dict, which receives the seconds of its
stages (evaluate, witness_commit, phase_one and phase_two summed over the
layers, layer_proofs, final_proofs).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ...host.pairing import PairingCurve
from ...serialize.tobytes import frs_bytes, point_bytes, points_bytes
from ...transcript import Transcript
from ..groth16.prover import Stages
from ..hyrax.params import (
    EqProof,
    LogDotProductProof,
    Parameters as HyraxParameters,
    ProductProof,
    challenge32,
)
from ..spartan.common import packing_poly_commit, poly_commit_vec
from .circuit import Circuit
from .linear_gkr import (
    DeviceLayer,
    DeviceRounds,
    HostRounds,
    _combine,
    _poly_eval,
    _use_device,
    eval_output,
    eval_value,
    initialize_phase_one,
    initialize_phase_two,
)


class Parameters(HyraxParameters):
    """libra params (same structure; its own param hash label)."""

    def param_to_hash(self) -> int:
        curve = self.curve
        t = Transcript(b"libra - param_to_hash")
        t.append_u64(b"r1cs_satisfied_params_pc_params_n", self.pc_params.n)

        def absorb(mc):
            t.append_u64(b"MultiCommitmentParameters_n", mc.n)
            t.append_message(b"MultiCommitmentParameters_h", point_bytes(curve, mc.h))
            for g in mc.generators:
                t.append_message(
                    b"MultiCommitmentParameters_generators", point_bytes(curve, g)
                )

        absorb(self.pc_params.gen_n)
        absorb(self.pc_params.gen_1)
        absorb(self.sc_params.gen_1)
        absorb(self.sc_params.gen_3)
        absorb(self.sc_params.gen_4)
        from ..spartan.common import challenge_fr

        return challenge_fr(curve, t, b"challenge_nextround")


@dataclass
class SumCheckEvalProof:
    d_commit: object
    dot_cd_commit: object
    z: list[int]
    z_delta: int
    z_beta: int

    @classmethod
    def prover(cls, curve, params, poly_size, poly, comm_poly, blind_poly, claim,
               blind_claim, eval_v, blind_eval, r, rng, transcript, device="cuda"):
        p = curve.fr.modulus
        w = [challenge32(curve, transcript, b"combine_two_claims_to_one") for _ in range(2)]
        polynomial = list(poly) + [0] * (poly_size - len(poly))
        claim_value = (w[0] * claim + w[1] * eval_v) % p
        blind = (w[0] * blind_claim + w[1] * blind_eval) % p
        coeffs = []
        rc = 1
        for _ in range(poly_size):
            coeffs.append((w[0] + w[1] * rc) % p)
            rc = rc * r % p
        coeffs[0] = (coeffs[0] + w[0]) % p
        transcript.append_message(b"Cx", point_bytes(curve, comm_poly))
        comm_claim_value = poly_commit_vec(
            curve, params.gen_1.generators, [claim_value], params.gen_1.h, blind, device=device
        )
        transcript.append_message(b"Cy", point_bytes(curve, comm_claim_value))
        d_vec = [rng.randrange(p) for _ in range(poly_size)]
        r_delta = rng.randrange(p)
        d_commit = poly_commit_vec(curve, params.gen_3.generators, d_vec, params.gen_3.h, r_delta,
                                   device=device)
        transcript.append_message(b"delta", point_bytes(curve, d_commit))
        r_beta = rng.randrange(p)
        dot_cd = sum(c * d % p for c, d in zip(coeffs, d_vec)) % p
        dot_cd_commit = poly_commit_vec(
            curve, params.gen_1.generators, [dot_cd], params.gen_1.h, r_beta, device=device
        )
        transcript.append_message(b"beta", point_bytes(curve, dot_cd_commit))
        c = challenge32(curve, transcript, b"c")
        z = [(c * polynomial[i] + d_vec[i]) % p for i in range(poly_size)]
        return cls(
            d_commit=d_commit, dot_cd_commit=dot_cd_commit, z=z,
            z_delta=(c * blind_poly + r_delta) % p,
            z_beta=(c * blind + r_beta) % p,
        )

    def verify(self, curve, params, comm_poly, comm_eval, comm_claim, r, bit_size, transcript,
               device="cuda"):
        p = curve.fr.modulus
        g1 = curve.g1
        w = [challenge32(curve, transcript, b"combine_two_claims_to_one") for _ in range(2)]
        transcript.append_message(b"Cx", point_bytes(curve, comm_poly))
        comm_claim_value = g1.add(g1.mul(comm_claim, w[0]), g1.mul(comm_eval, w[1]))
        transcript.append_message(b"Cy", point_bytes(curve, comm_claim_value))
        transcript.append_message(b"delta", point_bytes(curve, self.d_commit))
        transcript.append_message(b"beta", point_bytes(curve, self.dot_cd_commit))
        c = challenge32(curve, transcript, b"c")
        coeffs = []
        rc = 1
        for _ in range(bit_size):
            coeffs.append((w[0] + w[1] * rc) % p)
            rc = rc * r % p
        coeffs[0] = (coeffs[0] + w[0]) % p
        lhs = g1.add(g1.mul(comm_poly, c), self.d_commit)
        rhs = poly_commit_vec(curve, params.gen_3.generators, self.z, params.gen_3.h,
                              self.z_delta, device=device)
        if lhs != rhs:
            return False
        lhs = g1.add(g1.mul(comm_claim_value, c), self.dot_cd_commit)
        s = sum(self.z[i] * coeffs[i] % p for i in range(bit_size)) % p
        rhs = poly_commit_vec(curve, params.gen_1.generators, [s], params.gen_1.h, self.z_beta,
                              device=device)
        return lhs == rhs


@dataclass
class ZKSumCheckProof:
    comm_polys: list
    comm_evals: list
    proofs: list[SumCheckEvalProof]

    @classmethod
    def _rounds(cls, curve, params, engine, bit_size, claim,
                blind_claim, rng, transcript, device="cuda"):
        """engine: HostRounds or DeviceRounds (linear_gkr) — evals()/bind()
        over the halving tables; commitments/sigma proofs stay host-side."""
        p = curve.fr.modulus
        two_inv = pow(2, -1, p)
        blind_polys = [rng.randrange(p) for _ in range(bit_size)]
        blind_evals = [rng.randrange(p) for _ in range(bit_size)]
        rs = []
        comm_claim = poly_commit_vec(
            curve, params.gen_1.generators, [claim], params.gen_1.h, blind_claim, device=device
        )
        comm_polys, comm_evals, proofs = [], [], []
        for i in range(bit_size):
            eval_0, eval_2 = engine.evals()
            eval_1 = (claim - eval_0) % p
            a_c = (eval_0 - 2 * eval_1 + eval_2) * two_inv % p
            c_c = eval_0 % p
            b_c = (eval_1 - a_c - c_c) % p
            poly = [c_c, b_c, a_c]
            comm_poly = poly_commit_vec(
                curve, params.gen_3.generators, poly, params.gen_3.h, blind_polys[i],
                device=device,
            )
            transcript.append_message(b"comm_poly", point_bytes(curve, comm_poly))
            r_i = challenge32(curve, transcript, b"challenge_nextround")
            engine.bind(r_i)
            eval_ri = _poly_eval(poly, r_i, p)
            comm_eval = poly_commit_vec(
                curve, params.gen_1.generators, [eval_ri], params.gen_1.h, blind_evals[i],
                device=device,
            )
            transcript.append_message(b"comm_claim_per_round", point_bytes(curve, comm_claim))
            transcript.append_message(b"comm_eval", point_bytes(curve, comm_eval))
            blind_claim_t = blind_claim if i == 0 else blind_evals[i - 1]
            prf = SumCheckEvalProof.prover(
                curve, params, 3, poly, comm_poly, blind_polys[i], claim,
                blind_claim_t, eval_ri, blind_evals[i], r_i, rng, transcript, device=device,
            )
            rs.append(r_i)
            claim = eval_ri
            comm_claim = comm_eval
            comm_evals.append(comm_eval)
            comm_polys.append(comm_poly)
            proofs.append(prf)
        return (
            cls(comm_polys=comm_polys, comm_evals=comm_evals, proofs=proofs),
            engine.finals(), blind_evals[bit_size - 1], rs,
        )

    @classmethod
    def phase_one_prover(cls, curve, params, f_vec, g_vec, bit_size, claim,
                         blind_claim, rng, transcript, engine=None, device="cuda"):
        p = curve.fr.modulus

        def term(f, tabs, j):
            mul, a1, a2 = tabs
            return (f[j] * mul[j] + f[j] * a1[j] + a2[j]) % p

        if engine is None:
            engine = HostRounds(p, f_vec, g_vec, term)
        proof, finals, blind, ru = cls._rounds(
            curve, params, engine, bit_size, claim, blind_claim, rng, transcript, device
        )
        return proof, finals[:4], blind, ru

    @classmethod
    def phase_two_prover(cls, curve, params, f_vec, g_vec, bit_size, claim,
                         blind_claim, rng, transcript, engine=None, device="cuda"):
        p = curve.fr.modulus
        mul_hg, add_hg, fu = g_vec

        def term(f, tabs, j):
            mul, add = tabs
            return (mul[j] * f[j] % p * fu + add[j] * fu + add[j] * f[j]) % p

        if engine is None:
            engine = HostRounds(p, f_vec, (mul_hg, add_hg), term)
        proof, finals, blind, rv = cls._rounds(
            curve, params, engine, bit_size, claim, blind_claim, rng, transcript, device,
        )
        return proof, finals[:3] + [fu], blind, rv


@dataclass
class ZKLayerProof:
    proof_phase_one: ZKSumCheckProof
    proof_phase_two: ZKSumCheckProof
    comm_x: object
    comm_y: object
    comm_z: object
    prod_proof: ProductProof
    eq_proof: EqProof


@dataclass
class ZKLinearGKRProof:
    comm_witness: list
    proofs: list[ZKLayerProof]
    prod_proof0: LogDotProductProof
    comm_y0: object
    eq_proof0: EqProof
    prod_proof1: LogDotProductProof
    comm_y1: object
    eq_proof1: EqProof

    @classmethod
    def prover(cls, params: Parameters, circuit: Circuit, inputs, witnesses,
               circuit_hash: int, params_hash: int, rng: random.Random,
               device="cuda", timings: dict | None = None):
        st = Stages(timings, device)
        curve = params.curve
        p = curve.fr.modulus
        g1 = curve.g1
        transcript = Transcript(b"libra - zk linear gkr")
        transcript.append_message(b"circuit_to_hash", frs_bytes(curve, [circuit_hash]))
        transcript.append_message(b"params_to_hash", frs_bytes(curve, [params_hash]))
        evals = circuit.evaluate(p, inputs, witnesses)
        transcript.append_message(b"input", frs_bytes(curve, inputs))
        transcript.append_message(b"output", frs_bytes(curve, evals[-1]))
        st.mark("evaluate")
        comm_witness, witness_blind = packing_poly_commit(
            curve, params.pc_params.gen_n.generators, witnesses,
            params.pc_params.gen_n.h, rng, True, device=device,
        )
        transcript.append_message(b"comm_witness", points_bytes(curve, comm_witness))
        st.mark("witness_commit")
        alpha, beta = 1, 0
        result_u, gu = eval_output(
            curve, evals[-1], circuit.layers[circuit.depth - 1].bit_size, transcript
        )
        gv = [0] * len(gu)
        result_v = 0
        proofs = []
        claim_blind = 0
        final_x = final_y = final_bx = final_by = 0
        for d in range(circuit.depth - 1, 0, -1):
            claim = (alpha * result_u + beta * result_v) % p
            uv_size = circuit.layers[d - 1].bit_size
            dev_layer = (
                DeviceLayer(
                    curve, gu, gv, circuit.layers[d].gates, evals[d - 1],
                    uv_size, alpha, beta, device,
                )
                if _use_device(uv_size)
                else None
            )
            if dev_layer is not None:
                engine1 = DeviceRounds(
                    dev_layer.ds, dev_layer.v_dev, dev_layer.tabs1
                )
                proof1, eval_ru, blind_u, ru = ZKSumCheckProof.phase_one_prover(
                    curve, params.sc_params, None, (None,) * 3, uv_size,
                    claim, claim_blind, rng, transcript, engine=engine1, device=device,
                )
            else:
                tabs1 = initialize_phase_one(
                    gu, gv, circuit.layers[d].gates, evals[d - 1], uv_size, alpha, beta, p
                )
                proof1, eval_ru, blind_u, ru = ZKSumCheckProof.phase_one_prover(
                    curve, params.sc_params, evals[d - 1], tabs1, uv_size, claim,
                    claim_blind, rng, transcript, device=device,
                )
            st.add("phase_one")
            claim = (eval_ru[0] * eval_ru[1] + eval_ru[0] * eval_ru[2] + eval_ru[3]) % p
            rx = rng.randrange(p)
            comm_x = poly_commit_vec(
                curve, params.sc_params.gen_1.generators, [eval_ru[0]],
                params.sc_params.gen_1.h, rx, device=device,
            )
            transcript.append_message(b"comm_x", point_bytes(curve, comm_x))
            if dev_layer is not None:
                tabs2, fu = dev_layer.phase_two(ru)
                engine2 = DeviceRounds(
                    dev_layer.ds, dev_layer.v_dev, tabs2, fu
                )
                proof2, eval_rv, blind_v, rv = ZKSumCheckProof.phase_two_prover(
                    curve, params.sc_params, None, (None, None, fu),
                    uv_size, claim, blind_u, rng, transcript, engine=engine2, device=device,
                )
            else:
                mul_hg, add_hg, fu = initialize_phase_two(
                    gu, gv, ru, circuit.layers[d].gates, evals[d - 1], uv_size, alpha, beta, p
                )
                proof2, eval_rv, blind_v, rv = ZKSumCheckProof.phase_two_prover(
                    curve, params.sc_params, evals[d - 1], (mul_hg, add_hg, fu),
                    uv_size, claim, blind_u, rng, transcript, device=device,
                )
            st.add("phase_two")
            ry = rng.randrange(p)
            comm_y = poly_commit_vec(
                curve, params.sc_params.gen_1.generators, [eval_rv[0]],
                params.sc_params.gen_1.h, ry, device=device,
            )
            transcript.append_message(b"comm_y", point_bytes(curve, comm_y))
            z = eval_ru[0] * eval_rv[0] % p
            rz = rng.randrange(p)
            prod_proof, _, _, comm_z = ProductProof.prover(
                curve, params.sc_params.gen_1, eval_ru[0], rx, eval_rv[0], ry,
                z, rz, rng, transcript, device=device,
            )
            ev = (z * eval_rv[1] + (eval_ru[0] + eval_rv[0]) * eval_rv[2]) % p
            ev_blind = (rz * eval_rv[1] + (rx + ry) * eval_rv[2]) % p
            eq_proof = EqProof.prover(
                curve, params.sc_params.gen_1, ev, ev_blind, ev, blind_v, rng, transcript,
                device=device,
            )
            if d > 1:
                gu, gv = ru, rv
                result_u, result_v = fu, eval_rv[0]
                alpha = challenge32(curve, transcript, b"challenge_alpha")
                beta = challenge32(curve, transcript, b"challenge_beta")
                claim_blind = (alpha * rx + beta * ry) % p
            else:
                gu, gv = ru, rv
                final_x, final_y = eval_ru[0], eval_rv[0]
                final_bx, final_by = rx, ry
            proofs.append(
                ZKLayerProof(proof1, proof2, comm_x, comm_y, comm_z, prod_proof, eq_proof)
            )
            st.add("layer_proofs")

        blind_eval0 = rng.randrange(p)
        eval_w_rx = eval_value(witnesses, gu[1:], p)
        prod_proof0, comm_y0 = LogDotProductProof.reduce_prover(
            curve, params.pc_params, witnesses, witness_blind, gu[1:],
            blind_eval0, eval_w_rx, rng, transcript, device=device,
        )
        eq_proof0 = EqProof.prover(
            curve, params.pc_params.gen_1, final_x, final_bx, final_x,
            (1 - gu[0]) * blind_eval0 % p, rng, transcript, device=device,
        )
        blind_eval1 = rng.randrange(p)
        eval_w_ry = eval_value(witnesses, gv[1:], p)
        prod_proof1, comm_y1 = LogDotProductProof.reduce_prover(
            curve, params.pc_params, witnesses, witness_blind, gv[1:],
            blind_eval1, eval_w_ry, rng, transcript, device=device,
        )
        eq_proof1 = EqProof.prover(
            curve, params.pc_params.gen_1, final_y, final_by, final_y,
            (1 - gv[0]) * blind_eval1 % p, rng, transcript, device=device,
        )
        st.mark("final_proofs")
        return (
            cls(
                comm_witness=comm_witness, proofs=proofs,
                prod_proof0=prod_proof0, comm_y0=comm_y0, eq_proof0=eq_proof0,
                prod_proof1=prod_proof1, comm_y1=comm_y1, eq_proof1=eq_proof1,
            ),
            evals[-1],
        )

    def verify(self, params: Parameters, circuit: Circuit, outputs, inputs,
               circuit_hash: int, params_hash: int, device="cuda") -> bool:
        curve = params.curve
        p = curve.fr.modulus
        g1 = curve.g1
        transcript = Transcript(b"libra - zk linear gkr")
        transcript.append_message(b"circuit_to_hash", frs_bytes(curve, [circuit_hash]))
        transcript.append_message(b"params_to_hash", frs_bytes(curve, [params_hash]))
        transcript.append_message(b"input", frs_bytes(curve, inputs))
        transcript.append_message(b"output", frs_bytes(curve, outputs))
        transcript.append_message(b"comm_witness", points_bytes(curve, self.comm_witness))
        alpha, beta = 1, 0
        result_u, gu = eval_output(
            curve, outputs, circuit.layers[circuit.depth - 1].bit_size, transcript
        )
        claim = (alpha * result_u) % p
        comm_claim = poly_commit_vec(
            curve, params.pc_params.gen_1.generators, [claim], params.pc_params.gen_1.h, 0,
            device=device,
        )
        comm_x_final = comm_claim
        comm_y_final = comm_claim
        ru_vec: list[int] = []
        rv_vec: list[int] = []
        gu_vec = list(gu)
        gv_vec = list(gu)
        if circuit.depth - 1 != len(self.proofs):
            return False
        for d, lproof in enumerate(self.proofs):
            proof1, proof2 = lproof.proof_phase_one, lproof.proof_phase_two
            bit_size = circuit.layers[circuit.depth - d - 2].bit_size
            ru_vec, rv_vec = [], []
            for i in range(bit_size):
                comm_poly = proof1.comm_polys[i]
                transcript.append_message(b"comm_poly", point_bytes(curve, comm_poly))
                r_i = challenge32(curve, transcript, b"challenge_nextround")
                comm_eval = proof1.comm_evals[i]
                transcript.append_message(b"comm_claim_per_round", point_bytes(curve, comm_claim))
                transcript.append_message(b"comm_eval", point_bytes(curve, comm_eval))
                if not proof1.proofs[i].verify(
                    curve, params.sc_params, comm_poly, comm_eval, comm_claim, r_i, 3, transcript,
                    device=device,
                ):
                    return False
                ru_vec.append(r_i)
                comm_claim = comm_eval
            transcript.append_message(b"comm_x", point_bytes(curve, lproof.comm_x))
            for i in range(bit_size):
                comm_poly = proof2.comm_polys[i]
                transcript.append_message(b"comm_poly", point_bytes(curve, comm_poly))
                r_i = challenge32(curve, transcript, b"challenge_nextround")
                comm_eval = proof2.comm_evals[i]
                transcript.append_message(b"comm_claim_per_round", point_bytes(curve, comm_claim))
                transcript.append_message(b"comm_eval", point_bytes(curve, comm_eval))
                if not proof2.proofs[i].verify(
                    curve, params.sc_params, comm_poly, comm_eval, comm_claim, r_i, 3, transcript,
                    device=device,
                ):
                    return False
                rv_vec.append(r_i)
                comm_claim = comm_eval
            transcript.append_message(b"comm_y", point_bytes(curve, lproof.comm_y))
            if not lproof.prod_proof.verify(
                curve, params.sc_params.gen_1, lproof.comm_x, lproof.comm_y,
                lproof.comm_z, transcript, device=device,
            ):
                return False
            add_eval, mul_eval = _eval_operators(
                curve, circuit.layers[circuit.depth - d - 1], gu_vec, gv_vec,
                ru_vec, rv_vec, alpha, beta,
            )
            comm_final = g1.add(
                g1.mul(g1.add(lproof.comm_x, lproof.comm_y), add_eval),
                g1.mul(lproof.comm_z, mul_eval),
            )
            if not lproof.eq_proof.verify(
                curve, params.sc_params.gen_1, comm_final, comm_claim, transcript, device=device
            ):
                return False
            gu_vec, gv_vec = list(ru_vec), list(rv_vec)
            if d < circuit.depth - 2:
                alpha = challenge32(curve, transcript, b"challenge_alpha")
                beta = challenge32(curve, transcript, b"challenge_beta")
                comm_claim = g1.add(
                    g1.mul(lproof.comm_x, alpha), g1.mul(lproof.comm_y, beta)
                )
            else:
                comm_x_final = lproof.comm_x
                comm_y_final = lproof.comm_y

        padded = list(inputs) + [0] * (
            (1 << (circuit.layers[0].bit_size - 1)) - len(inputs)
        )
        if not self.prod_proof0.reduce_verifier(
            curve, params.pc_params, ru_vec[1:], self.comm_witness, self.comm_y0, transcript,
            device=device,
        ):
            return False
        eval_input = eval_value(padded, ru_vec[1:], p)
        comm_input = poly_commit_vec(
            curve, params.pc_params.gen_1.generators, [eval_input],
            params.pc_params.gen_1.h, 0, device=device,
        )
        comm_eval_z = g1.add(
            g1.mul(self.comm_y0, (1 - ru_vec[0]) % p), g1.mul(comm_input, ru_vec[0])
        )
        if not self.eq_proof0.verify(
            curve, params.pc_params.gen_1, comm_x_final, comm_eval_z, transcript, device=device
        ):
            return False
        if not self.prod_proof1.reduce_verifier(
            curve, params.pc_params, rv_vec[1:], self.comm_witness, self.comm_y1, transcript,
            device=device,
        ):
            return False
        eval_input = eval_value(padded, rv_vec[1:], p)
        comm_input = poly_commit_vec(
            curve, params.pc_params.gen_1.generators, [eval_input],
            params.pc_params.gen_1.h, 0, device=device,
        )
        comm_eval_z = g1.add(
            g1.mul(self.comm_y1, (1 - rv_vec[0]) % p), g1.mul(comm_input, rv_vec[0])
        )
        return self.eq_proof1.verify(
            curve, params.pc_params.gen_1, comm_y_final, comm_eval_z, transcript, device=device
        )


def _eval_operators(curve, layer, gu, gv, ru, rv, alpha, beta):
    """Layer wiring-predicate evals (parity: libra circuit.rs:82-108)."""
    from ..spartan.polynomial import eval_eq

    p = curve.fr.modulus
    eq_gu = eval_eq(list(gu), p)
    eq_gv = eval_eq(list(gv), p)
    eq_ru = eval_eq(list(ru), p)
    eq_rv = eval_eq(list(rv), p)
    add_eval = 0
    mul_eval = 0
    for gate in layer.gates:
        ev = (alpha * eq_gu[gate.g] + beta * eq_gv[gate.g]) % p
        contrib = eq_ru[gate.left_node] * eq_rv[gate.right_node] % p * ev % p
        if gate.op == 0:
            add_eval = (add_eval + contrib) % p
        elif gate.op == 1:
            mul_eval = (mul_eval + contrib) % p
    return add_eval, mul_eval

"""Hyrax top-level data-parallel prover/verifier.

Port of the reference's `schemes/hyrax/hyrax_proof.py` (parity: ckb-zkp
hyrax/src/hyrax_proof.rs:29-355 and evaluate.rs:eval_outputs), word for
word but for the device: `HyraxProof.prover` and `verify` take `device`
(default "cuda") down to the witness commitment (`packing_poly_commit`,
its rows as one device MSM), `poly_commit_vec`, the layers' zk sumchecks
(device tables) and the sigma protocols; `prover` also takes a `timings`
dict, which receives the seconds of its stages (evaluate,
witness_commit, sumchecks, final_proofs).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ...host.pairing import PairingCurve
from ...serialize.tobytes import frs_bytes, point_bytes, points_bytes
from ...transcript import Transcript
from ..groth16.prover import Stages
from ..spartan.common import packing_poly_commit, poly_commit_vec
from ..spartan.polynomial import eval_eq
from .circuit import Circuit
from .params import EqProof, LogDotProductProof, Parameters, challenge32
from .zk_sumcheck import ZkSumcheckProof


def eval_value(values, r, p):
    eq = eval_eq(r, p)
    return sum(v * e % p for v, e in zip(values, eq)) % p


def eval_outputs(curve, outputs: list[list[int]], transcript):
    p = curve.fr.modulus
    n = 1 << (len(outputs) - 1).bit_length() if len(outputs) > 1 else 1
    log_n = n.bit_length() - 1
    g = len(outputs[0])
    g = 1 << (g - 1).bit_length() if g > 1 else 1
    log_g = g.bit_length() - 1
    q_vec = [challenge32(curve, transcript, b"challenge_nextround") for _ in range(log_g)]
    eq_q = eval_eq(q_vec, p)
    eq_qs = []
    for output in outputs:
        padded = list(output) + [0] * (g - len(output))
        eq_qs.append(sum(padded[j] * eq_q[j] % p for j in range(g)) % p)
    q_aside = [challenge32(curve, transcript, b"challenge_nextround") for _ in range(log_n)]
    eq_aside = eval_eq(q_aside, p)
    eq_qs += [0] * (n - len(eq_qs))
    result = sum(eq_qs[i] * eq_aside[i] % p for i in range(n)) % p
    return result, q_aside, q_vec


@dataclass
class HyraxProof:
    comm_witness: list
    proofs: list[ZkSumcheckProof]
    prod_proof0: LogDotProductProof
    comm_y0: object
    eq_proof0: EqProof
    prod_proof1: LogDotProductProof
    comm_y1: object
    eq_proof1: EqProof

    @classmethod
    def prover(cls, params: Parameters, witnesses, inputs, circuit: Circuit,
               circuit_hash: int, param_hash: int, n: int, rng: random.Random,
               device="cuda", timings: dict | None = None):
        st = Stages(timings, device)
        curve = params.curve
        p = curve.fr.modulus
        transcript = Transcript(b"hyrax - linear gkr")
        transcript.append_message(b"circuit_to_hash", frs_bytes(curve, [circuit_hash]))
        transcript.append_message(b"param_to_hash", frs_bytes(curve, [param_hash]))

        circuit_evals = []
        outputs = []
        for i in range(n):
            transcript.append_message(b"input_i", frs_bytes(curve, inputs[i]))
            ev = circuit.evaluate(p, inputs[i], witnesses[i])
            outputs.append(ev[0])
            circuit_evals.append(ev)
            transcript.append_message(b"output_i", frs_bytes(curve, ev[0]))
        assert n & (n - 1) == 0 and n > 0
        st.mark("evaluate")

        witness_vec = []
        for i in range(n):
            w = list(witnesses[i])
            wl = len(w)
            wp = 1 << (wl - 1).bit_length() if wl > 1 else 1
            witness_vec.extend(w + [0] * (wp - wl))
        comm_witness, witness_blind = packing_poly_commit(
            curve, params.pc_params.gen_n.generators, witness_vec,
            params.pc_params.gen_n.h, rng, True, device=device,
        )
        transcript.append_message(b"comm_witness", points_bytes(curve, comm_witness))
        st.mark("witness_commit")

        result_u, q_aside_vec, ql_vec = eval_outputs(curve, outputs, transcript)
        qr_vec = list(ql_vec)
        u0, u1 = 1, 0
        rc0 = 0
        comm_a = poly_commit_vec(
            curve, params.sc_params.gen_1.generators, [result_u],
            params.sc_params.gen_1.h, 0, device=device,
        )
        transcript.append_message(b"comm_claim_a0", point_bytes(curve, comm_a))
        comm_claim = comm_a
        claim = result_u
        proofs = []
        x = y = rx = ry = 0
        for d in range(circuit.depth - 1):
            next_gate_num = circuit.layers[circuit.depth - d - 2].gates_count
            ng = 1 << (next_gate_num - 1).bit_length() if next_gate_num > 1 else 1
            layer_evals = []
            for i in range(next_gate_num):
                evals = [circuit_evals[t][d + 1][i] for t in range(len(circuit_evals))]
                evals += [0] * (n - len(circuit_evals))
                layer_evals.append(evals)
            layer_evals += [[0] * n for _ in range(next_gate_num, ng)]

            proof, rs_, r0_, r1_, eval_vec, blind_vec = ZkSumcheckProof.prover(
                curve, params.sc_params, claim, comm_claim, rc0, (u0, u1),
                (q_aside_vec, ql_vec, qr_vec),
                circuit.layers[circuit.depth - d - 1].gates,
                layer_evals, n, ng, rng, transcript, device=device,
            )
            q_aside_vec, ql_vec, qr_vec = rs_, r0_, r1_
            x, y = eval_vec
            rx, ry = blind_vec
            if d < circuit.depth - 2:
                u0 = challenge32(curve, transcript, b"u0")
                u1 = challenge32(curve, transcript, b"u1")
                comm_claim = curve.g1.add(
                    curve.g1.mul(proof.comm_x, u0), curve.g1.mul(proof.comm_y, u1)
                )
                rc0 = (rx * u0 + ry * u1) % p
                claim = (x * u0 + y * u1) % p
                transcript.append_message(b"comm_a_i", point_bytes(curve, comm_claim))
            proofs.append(proof)
        st.mark("sumchecks")

        rl_q_vec = list(q_aside_vec) + list(ql_vec[1:])
        blind_eval0 = rng.randrange(p)
        eval_w_rl = eval_value(witness_vec, rl_q_vec, p)
        prod_proof0, comm_y0 = LogDotProductProof.reduce_prover(
            curve, params.pc_params, witness_vec, witness_blind, rl_q_vec,
            blind_eval0, eval_w_rl, rng, transcript, device=device,
        )
        eval_at_zy_blind0 = (1 - ql_vec[0]) * blind_eval0 % p
        eq_proof0 = EqProof.prover(
            curve, params.pc_params.gen_1, x, rx, x, eval_at_zy_blind0, rng, transcript,
            device=device,
        )

        rr_q_vec = list(q_aside_vec) + list(qr_vec[1:])
        blind_eval1 = rng.randrange(p)
        eval_w_rr = eval_value(witness_vec, rr_q_vec, p)
        prod_proof1, comm_y1 = LogDotProductProof.reduce_prover(
            curve, params.pc_params, witness_vec, witness_blind, rr_q_vec,
            blind_eval1, eval_w_rr, rng, transcript, device=device,
        )
        eval_at_zy_blind1 = (1 - qr_vec[0]) * blind_eval1 % p
        eq_proof1 = EqProof.prover(
            curve, params.pc_params.gen_1, y, ry, y, eval_at_zy_blind1, rng, transcript,
            device=device,
        )
        st.mark("final_proofs")
        return (
            cls(
                comm_witness=comm_witness, proofs=proofs,
                prod_proof0=prod_proof0, comm_y0=comm_y0, eq_proof0=eq_proof0,
                prod_proof1=prod_proof1, comm_y1=comm_y1, eq_proof1=eq_proof1,
            ),
            outputs,
        )

    def verify(self, params: Parameters, outputs, inputs, circuit: Circuit,
               circuit_hash: int, param_hash: int, device="cuda") -> bool:
        curve = params.curve
        p = curve.fr.modulus
        g1 = curve.g1
        transcript = Transcript(b"hyrax - linear gkr")
        transcript.append_message(b"circuit_to_hash", frs_bytes(curve, [circuit_hash]))
        transcript.append_message(b"param_to_hash", frs_bytes(curve, [param_hash]))
        n = len(outputs)
        if n == 0 or n & (n - 1):
            return False
        for i in range(n):
            transcript.append_message(b"input_i", frs_bytes(curve, inputs[i]))
            transcript.append_message(b"output_i", frs_bytes(curve, outputs[i]))
        transcript.append_message(b"comm_witness", points_bytes(curve, self.comm_witness))
        result_u, q_aside_vec, ql_vec = eval_outputs(curve, outputs, transcript)
        qr_vec = list(ql_vec)
        comm_a = poly_commit_vec(
            curve, params.sc_params.gen_1.generators, [result_u],
            params.sc_params.gen_1.h, 0, device=device,
        )
        transcript.append_message(b"comm_claim_a0", point_bytes(curve, comm_a))
        comm_x = comm_a
        comm_y = comm_a
        u0, u1 = 1, 0
        for d in range(circuit.depth - 1):
            next_gate_num = circuit.layers[circuit.depth - d - 2].gates_count
            ng = 1 << (next_gate_num - 1).bit_length() if next_gate_num > 1 else 1
            res = self.proofs[d].verify(
                curve, params.sc_params, comm_a, (u0, u1),
                (q_aside_vec, ql_vec, qr_vec),
                circuit.layers[circuit.depth - d - 1].gates, n, ng, transcript,
                device=device,
            )
            if res is None:
                return False
            comm_x, comm_y, q_aside_vec, ql_vec, qr_vec = res
            if d < circuit.depth - 2:
                u0 = challenge32(curve, transcript, b"u0")
                u1 = challenge32(curve, transcript, b"u1")
                comm_a = g1.add(g1.mul(comm_x, u0), g1.mul(comm_y, u1))
                transcript.append_message(b"comm_a_i", point_bytes(curve, comm_a))

        input_vec = []
        for i in range(n):
            inp = list(inputs[i])
            al = len(inp)
            ap = 1 << (al - 1).bit_length() if al > 1 else 1
            input_vec.extend(inp + [0] * (ap - al))

        rl_q_vec = list(q_aside_vec) + list(ql_vec[1:])
        if not self.prod_proof0.reduce_verifier(
            curve, params.pc_params, rl_q_vec, self.comm_witness, self.comm_y0, transcript,
            device=device,
        ):
            return False
        eval_input = eval_value(input_vec, rl_q_vec, p)
        comm_input = poly_commit_vec(
            curve, params.pc_params.gen_1.generators, [eval_input],
            params.pc_params.gen_1.h, 0, device=device,
        )
        comm_eval_z = g1.add(
            g1.mul(self.comm_y0, (1 - ql_vec[0]) % p), g1.mul(comm_input, ql_vec[0])
        )
        if not self.eq_proof0.verify(
            curve, params.pc_params.gen_1, comm_x, comm_eval_z, transcript, device=device
        ):
            return False

        rr_q_vec = list(q_aside_vec) + list(qr_vec[1:])
        if not self.prod_proof1.reduce_verifier(
            curve, params.pc_params, rr_q_vec, self.comm_witness, self.comm_y1, transcript,
            device=device,
        ):
            return False
        eval_input = eval_value(input_vec, rr_q_vec, p)
        comm_input = poly_commit_vec(
            curve, params.pc_params.gen_1.generators, [eval_input],
            params.pc_params.gen_1.h, 0, device=device,
        )
        comm_eval_z = g1.add(
            g1.mul(self.comm_y1, (1 - qr_vec[0]) % p), g1.mul(comm_input, qr_vec[0])
        )
        if not self.eq_proof1.verify(
            curve, params.pc_params.gen_1, comm_y, comm_eval_z, transcript, device=device
        ):
            return False
        return True

"""Hyrax per-layer zero-knowledge sumcheck (three phases).

Port of the reference's `schemes/hyrax/zk_sumcheck.py` (parity: ckb-zkp
hyrax/src/zk_sumcheck_proof.rs and evaluate.rs:151-251, construct_matrix /
convert_to_bit). The round polynomials are committed (gen_4 cubic / gen_3
quadratic) and opened in one batched sigma protocol at the end against a
random linear combination of the sumcheck consistency matrix rows.

Word for word but for the device: `ZkSumcheckProof.prover` and `verify`
take `device` (default "cuda") down to `poly_commit_vec` and the sigma
protocols, and the prover's tables, where `_use_device_tables` sends them
to the device, are torch tensors there (`DeviceSumcheck(curve.fr,
device)`: the gate masks and indices, TP, CE), where the reference builds
them with `jnp`.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...serialize.tobytes import point_bytes
from ..spartan.common import poly_commit_vec
from ..spartan.polynomial import combine_with_n, eval_eq, eval_eq_x_y
from .params import ProductProof, challenge32


def _poly_eval(coeffs, x, p):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def _use_device_tables(n: int, ng: int) -> bool:
    """Route the sumcheck tables to the device when the data-parallel work
    (instances x gates) amortizes the dispatch round-trips."""
    from ...ops.sumcheck import DEVICE_SUMCHECK_MIN

    return n * ng >= DEVICE_SUMCHECK_MIN * 4


def convert_to_bit(n: int, log_g: int) -> list[int]:
    out = []
    while n > 0:
        out.append(n & 1)
        n >>= 1
    out += [0] * (log_g - len(out))
    out.reverse()
    return out


def construct_matrix(rs3, q_vec, gates, u, log_n, log_g, p):
    """The (log_n + 2 log_g + 1) x (4 log_n + 6 log_g + 3) consistency matrix."""
    rs, r0, r1 = rs3
    q_aside_vec, q_left_vec, q_right_vec = q_vec
    u0, u1 = u
    rs_vec = list(r0) + list(r1)
    rows = log_n + 2 * log_g + 1
    cols = 4 * log_n + 6 * log_g + 3
    mm = [[0] * cols for _ in range(rows)]
    mm[0][0] = 2
    mm[0][1] = 1
    mm[0][2] = 1
    mm[0][3] = 1
    for i in range(log_n - 1):
        r = (-1) % p
        mm[i + 1][i * 4] = r
        r = r * rs[i] % p
        mm[i + 1][i * 4 + 1] = r
        r = r * rs[i] % p
        mm[i + 1][i * 4 + 2] = r
        r = r * rs[i] % p
        mm[i + 1][i * 4 + 3] = r
        mm[i + 1][i * 4 + 4] = 2
        mm[i + 1][i * 4 + 5] = 1
        mm[i + 1][i * 4 + 6] = 1
        mm[i + 1][i * 4 + 7] = 1
    r = (-1) % p
    base = (log_n - 1) * 4
    mm[log_n][base] = r
    r = r * rs[log_n - 1] % p
    mm[log_n][base + 1] = r
    r = r * rs[log_n - 1] % p
    mm[log_n][base + 2] = r
    r = r * rs[log_n - 1] % p
    mm[log_n][base + 3] = r
    mm[log_n][base + 4] = 2
    mm[log_n][base + 5] = 1
    mm[log_n][base + 6] = 1
    for i in range(2 * log_g):
        r = (-1) % p
        b = log_n * 4 + i * 3
        mm[log_n + 1 + i][b] = r
        r = r * rs_vec[i] % p
        mm[log_n + 1 + i][b + 1] = r
        r = r * rs_vec[i] % p
        mm[log_n + 1 + i][b + 2] = r
        mm[log_n + 1 + i][b + 3] = 2
        mm[log_n + 1 + i][b + 4] = 1
        mm[log_n + 1 + i][b + 5] = 1

    eval_0 = eval_eq_x_y(list(q_aside_vec), list(rs), p)
    eq_ql = eval_eq(list(q_left_vec), p)
    eq_qr = eval_eq(list(q_right_vec), p)
    eq_r0 = eval_eq(list(r0), p)
    eq_r1 = eval_eq(list(r1), p)
    add_eval = 0
    mul_eval = 0
    for gate in gates:
        ev = eval_0 * ((eq_ql[gate.g] * u0 + eq_qr[gate.g] * u1) % p) % p
        contrib = eq_r0[gate.left_node] * eq_r1[gate.right_node] % p * ev % p
        if gate.op == 0:
            add_eval = (add_eval + contrib) % p
        elif gate.op == 1:
            mul_eval = (mul_eval + contrib) % p
    mm[log_n + 2 * log_g][log_n * 4 + log_g * 6] = add_eval
    mm[log_n + 2 * log_g][log_n * 4 + log_g * 6 + 1] = add_eval
    mm[log_n + 2 * log_g][log_n * 4 + log_g * 6 + 2] = mul_eval
    return mm


@dataclass
class ZkSumcheckProof:
    prod_proof: ProductProof
    comm_a0: object
    comm_c: object
    comm_x: object
    comm_y: object
    comm_z: object
    comm_polys: list
    comm_evals: list
    comm_deltas: list
    z_vec: list[int]
    z_delta_vec: list[int]
    zc: int

    # ------------------------- prover -------------------------
    @classmethod
    def prover(cls, curve, params, claim, comm_a0, rc0, u, q_vec, gates,
               circuit_evals, n, ng, rng, transcript, device="cuda"):
        p = curve.fr.modulus
        u0, u1 = u
        q_aside_vec, ql_vec, qr_vec = q_vec
        comm_claim = comm_a0
        log_g = len(ql_vec)
        log_ng = ng.bit_length() - 1
        log_n = n.bit_length() - 1
        six_inv = pow(6, -1, p)
        two_inv = pow(2, -1, p)
        circuit_evals = [list(v) for v in circuit_evals]
        assert len(q_aside_vec) == log_n

        r_alpha_vec = [rng.randrange(p) for _ in range(log_n + 2 * log_ng)]
        r_alpha_eval_vec = [rng.randrange(p) for _ in range(log_n + 2 * log_ng)]
        polys, comm_polys, comm_evals = [], [], []

        use_dev0 = _use_device_tables(n, ng)
        eq_ql = eval_eq(list(ql_vec), p)
        eq_qr = eval_eq(list(qr_vec), p)
        xg_q = [(a * u0 + b * u1) % p for a, b in zip(eq_ql, eq_qr)]
        if not use_dev0:
            eq_vec = eval_eq(list(q_aside_vec), p)
            temp_vec = [[e * x % p for e in eq_vec] for x in xg_q]
            assert len(temp_vec) == len(gates)

        def gate_term(pv, lv, rv, op):
            return pv * ((lv + rv) % p if op == 0 else lv * rv % p) % p

        # device-resident tables (VERDICT r2 item 4): the per-instance /
        # per-node eval tables live on device, halving each round; only
        # (eval_0, eval_2[, eval_3]) cross to the host where the
        # commitments, transcript and sigma proofs run. Proofs are
        # byte-identical to the host path (tests/test_hyrax.py equality).
        use_dev = use_dev0
        if use_dev:
            import numpy as np
            import torch

            from ...ops.sumcheck import DeviceSumcheck

            ds = DeviceSumcheck(curve.fr, device)
            frd = ds.fr
            li = [g.left_node for g in gates]
            ri = [g.right_node for g in gates]
            mulmask = torch.as_tensor(np.asarray([g.op == 1 for g in gates]),
                                      device=frd.device)
            li_d = torch.as_tensor(np.asarray(li, np.int64), device=frd.device)
            ri_d = torch.as_tensor(np.asarray(ri, np.int64), device=frd.device)
            eq_dev = ds.eval_eq(list(q_aside_vec))  # (n, L)
            xg_dev = ds.encode_table(xg_q)  # (ng, L)
            TP = frd.mul(xg_dev[:, None], eq_dev[None])
            CE = ds.encode_table(
                [v for row in circuit_evals for v in row]
            ).reshape(len(circuit_evals), n, frd.L)

        # ---- sumcheck #1 (instance bits) ----
        rs = []
        size = n
        for j in range(log_n):
            size //= 2
            if use_dev:
                eval_0, eval_2, eval_3 = ds.hyrax_p1_round(
                    TP, CE, li_d, ri_d, mulmask
                )
            else:
                eval_0 = eval_2 = eval_3 = 0
                for gate, tp in zip(gates, temp_vec):
                    lvv = circuit_evals[gate.left_node]
                    rvv = circuit_evals[gate.right_node]
                    eval_0 = (
                        eval_0
                        + sum(gate_term(tp[t], lvv[t], rvv[t], gate.op) for t in range(size))
                    ) % p
                    tp2 = combine_with_n(tp, 2, p)
                    lv2 = combine_with_n(lvv, 2, p)
                    rv2 = combine_with_n(rvv, 2, p)
                    eval_2 = (
                        eval_2
                        + sum(gate_term(tp2[t], lv2[t], rv2[t], gate.op) for t in range(size))
                    ) % p
                    tp3 = combine_with_n(tp, 3, p)
                    lv3 = combine_with_n(lvv, 3, p)
                    rv3 = combine_with_n(rvv, 3, p)
                    eval_3 = (
                        eval_3
                        + sum(gate_term(tp3[t], lv3[t], rv3[t], gate.op) for t in range(size))
                    ) % p
            eval_1 = (claim - eval_0) % p
            a_c = (-eval_0 + 3 * eval_1 - 3 * eval_2 + eval_3) * six_inv % p
            b_c = (2 * eval_0 - 5 * eval_1 + 4 * eval_2 - eval_3) * two_inv % p
            c_c = (eval_1 - eval_0 - a_c - b_c) % p
            coeffs = [eval_0 % p, c_c, b_c, a_c]
            polys.append(coeffs)
            comm_poly = poly_commit_vec(
                curve, params.gen_4.generators, coeffs, params.gen_4.h, r_alpha_vec[j],
                device=device,
            )
            transcript.append_message(b"comm_poly", point_bytes(curve, comm_poly))
            r_i = challenge32(curve, transcript, b"challenge_nextround")
            if use_dev:
                TP = ds.bind_axis1(TP, r_i)
                CE = ds.bind_axis1(CE, r_i)
            else:
                temp_vec = [combine_with_n(t, r_i, p) for t in temp_vec]
                circuit_evals = [combine_with_n(v, r_i, p) for v in circuit_evals]
            eval_ri = _poly_eval(coeffs, r_i, p)
            comm_eval = poly_commit_vec(
                curve, params.gen_1.generators, [eval_ri], params.gen_1.h,
                r_alpha_eval_vec[j], device=device,
            )
            transcript.append_message(b"comm_claim_per_round", point_bytes(curve, comm_claim))
            transcript.append_message(b"comm_eval", point_bytes(curve, comm_eval))
            rs.append(r_i)
            comm_polys.append(comm_poly)
            comm_evals.append(comm_eval)
            comm_claim = comm_eval
            claim = eval_ri

        if use_dev:
            v_dev = CE[:, 0]  # (num_nodes, L); num_nodes == ng node space
            tpx_dev = TP[:, 0]  # (ng, L)
            LEQ = ds.one_hot_rows(li, ng)
            REQ = ds.one_hot_rows(ri, ng)
            rv_dev = v_dev[ri_d]
            VL = v_dev
        else:
            v_vec = [ev[0] for ev in circuit_evals]
            temp_p_xg_vec = [t[0] for t in temp_vec]
            eq_node_vec = [eval_eq(convert_to_bit(i, log_ng), p) for i in range(ng)]
            left_eq_vec = [list(eq_node_vec[g.left_node]) for g in gates]
            right_eq_vec = [list(eq_node_vec[g.right_node]) for g in gates]

        # ---- sumcheck #2 (left gate bits) ----
        size = ng
        r0 = []
        if not use_dev:
            v_vec_left = list(v_vec)
        for j in range(log_ng):
            size //= 2
            if use_dev:
                eval_0, eval_2 = ds.hyrax_p23_round(
                    LEQ, VL, tpx_dev, rv_dev, mulmask
                )
            else:
                eval_0 = eval_2 = 0
                for tpx, gate, leq in zip(temp_p_xg_vec, gates, left_eq_vec):
                    rv = v_vec[gate.right_node]
                    for i in range(size):
                        lv = v_vec_left[i]
                        eval_0 = (
                            eval_0
                            + leq[i] * tpx % p * ((lv + rv) % p if gate.op == 0 else lv * rv % p)
                        ) % p
                    leq2 = combine_with_n(leq, 2, p)
                    vl2 = combine_with_n(v_vec_left, 2, p)
                    for i in range(size):
                        lv = vl2[i]
                        eval_2 = (
                            eval_2
                            + leq2[i] * tpx % p * ((lv + rv) % p if gate.op == 0 else lv * rv % p)
                        ) % p
            eval_1 = (claim - eval_0) % p
            a_c = (eval_0 - 2 * eval_1 + eval_2) * two_inv % p
            c_c = eval_0 % p
            b_c = (eval_1 - a_c - c_c) % p
            coeffs = [c_c, b_c, a_c]
            polys.append(coeffs)
            comm_poly = poly_commit_vec(
                curve, params.gen_3.generators, coeffs, params.gen_3.h,
                r_alpha_vec[log_n + j], device=device,
            )
            transcript.append_message(b"comm_poly", point_bytes(curve, comm_poly))
            r_i = challenge32(curve, transcript, b"challenge_nextround")
            if use_dev:
                LEQ = ds.bind_axis1(LEQ, r_i)
                VL = ds.bind(VL, r_i)
            else:
                left_eq_vec = [combine_with_n(le, r_i, p) for le in left_eq_vec]
                v_vec_left = combine_with_n(v_vec_left, r_i, p)
            eval_ri = _poly_eval(coeffs, r_i, p)
            comm_eval = poly_commit_vec(
                curve, params.gen_1.generators, [eval_ri], params.gen_1.h,
                r_alpha_eval_vec[log_n + j], device=device,
            )
            transcript.append_message(b"comm_claim_per_round", point_bytes(curve, comm_claim))
            transcript.append_message(b"comm_eval", point_bytes(curve, comm_eval))
            r0.append(r_i)
            comm_polys.append(comm_poly)
            comm_evals.append(comm_eval)
            comm_claim = comm_eval
            claim = eval_ri

        if use_dev:
            tpx_dev = frd.mul(LEQ[:, 0], tpx_dev)
            x = ds.decode_scalar(VL[0])
            VR = v_dev
            xg_dev = frd.encode([x]).expand(rv_dev.shape)
        else:
            temp_p_xg_vec = [le[0] * t % p for le, t in zip(left_eq_vec, temp_p_xg_vec)]
            x = v_vec_left[0]

        # ---- sumcheck #3 (right gate bits) ----
        size = ng
        r1 = []
        if not use_dev:
            v_vec_right = list(v_vec)
        for j in range(log_ng):
            size //= 2
            if use_dev:
                eval_0, eval_2 = ds.hyrax_p23_round(
                    REQ, VR, tpx_dev, xg_dev, mulmask
                )
            else:
                eval_0 = eval_2 = 0
                for tpx, gate, req in zip(temp_p_xg_vec, gates, right_eq_vec):
                    for i in range(size):
                        rv = v_vec_right[i]
                        eval_0 = (
                            eval_0
                            + req[i] * tpx % p * ((x + rv) % p if gate.op == 0 else x * rv % p)
                        ) % p
                    req2 = combine_with_n(req, 2, p)
                    vr2 = combine_with_n(v_vec_right, 2, p)
                    for i in range(size):
                        rv = vr2[i]
                        eval_2 = (
                            eval_2
                            + req2[i] * tpx % p * ((x + rv) % p if gate.op == 0 else x * rv % p)
                        ) % p
            eval_1 = (claim - eval_0) % p
            a_c = (eval_0 - 2 * eval_1 + eval_2) * two_inv % p
            c_c = eval_0 % p
            b_c = (eval_1 - a_c - c_c) % p
            coeffs = [c_c, b_c, a_c]
            polys.append(coeffs)
            comm_poly = poly_commit_vec(
                curve, params.gen_3.generators, coeffs, params.gen_3.h,
                r_alpha_vec[log_n + log_ng + j], device=device,
            )
            transcript.append_message(b"comm_poly", point_bytes(curve, comm_poly))
            r_i = challenge32(curve, transcript, b"challenge_nextround")
            if use_dev:
                REQ = ds.bind_axis1(REQ, r_i)
                VR = ds.bind(VR, r_i)
            else:
                right_eq_vec = [combine_with_n(re, r_i, p) for re in right_eq_vec]
                v_vec_right = combine_with_n(v_vec_right, r_i, p)
            eval_ri = _poly_eval(coeffs, r_i, p)
            comm_eval = poly_commit_vec(
                curve, params.gen_1.generators, [eval_ri], params.gen_1.h,
                r_alpha_eval_vec[log_n + log_g + j], device=device,
            )
            transcript.append_message(b"comm_claim_per_round", point_bytes(curve, comm_claim))
            transcript.append_message(b"comm_eval", point_bytes(curve, comm_eval))
            r1.append(r_i)
            comm_polys.append(comm_poly)
            comm_evals.append(comm_eval)
            comm_claim = comm_eval
            claim = eval_ri
        y = ds.decode_scalar(VR[0]) if use_dev else v_vec_right[0]

        m_vec = construct_matrix((rs, r0, r1), q_vec, gates, u, log_n, log_ng, p)
        pie_vec = []
        for coeffs in polys:
            pie_vec.extend(coeffs)
        pie_vec += [x, y, x * y % p]

        (prod_bits, comm_deltas, comm_c, z_vec, z_delta_vec, zc, blind_vec) = (
            cls._final_sigma(
                curve, params, (x, y), log_ng, log_n, m_vec, pie_vec,
                r_alpha_vec, rc0, rng, transcript, device=device,
            )
        )
        prod_proof, comm_x, comm_y, comm_z = prod_bits
        proof = cls(
            prod_proof=prod_proof, comm_a0=comm_a0, comm_c=comm_c,
            comm_x=comm_x, comm_y=comm_y, comm_z=comm_z,
            comm_polys=comm_polys, comm_evals=comm_evals, comm_deltas=comm_deltas,
            z_vec=z_vec, z_delta_vec=z_delta_vec, zc=zc,
        )
        return proof, rs, r0, r1, [x, y], blind_vec

    @classmethod
    def _final_sigma(cls, curve, params, xy, log_g, log_n, m_vec, pie_vec,
                     r_alpha_vec, rc0, rng, transcript, device="cuda"):
        p = curve.fr.modulus
        x, y = xy
        z = x * y % p
        rx, ry, rz = (rng.randrange(p) for _ in range(3))
        prod_proof, comm_x, comm_y, comm_z = ProductProof.prover(
            curve, params.gen_1, x, rx, y, ry, z, rz, rng, transcript, device=device
        )
        r_delta_vec: list[int] = []
        d_vec: list[int] = []
        comm_deltas = []
        for _ in range(log_n):
            ds = [rng.randrange(p) for _ in range(4)]
            r_delta = rng.randrange(p)
            d_vec.extend(ds)
            r_delta_vec.append(r_delta)
            dc = poly_commit_vec(curve, params.gen_4.generators, ds, params.gen_4.h, r_delta,
                                 device=device)
            transcript.append_message(b"comm_delta", point_bytes(curve, dc))
            comm_deltas.append(dc)
        for _ in range(2 * log_g):
            ds = [rng.randrange(p) for _ in range(3)]
            r_delta = rng.randrange(p)
            d_vec.extend(ds)
            r_delta_vec.append(r_delta)
            dc = poly_commit_vec(curve, params.gen_3.generators, ds, params.gen_3.h, r_delta,
                                 device=device)
            transcript.append_message(b"comm_delta", point_bytes(curve, dc))
            comm_deltas.append(dc)
        rou_vec = [
            challenge32(curve, transcript, b"challenge_nextround")
            for _ in range(log_n + 2 * log_g + 1)
        ]
        ncols = 4 * log_n + 6 * log_g + 3
        j_vec = [
            sum(rou_vec[j] * m_vec[j][k] for j in range(log_n + 2 * log_g + 1)) % p
            for k in range(ncols)
        ]
        rc = rng.randrange(p)
        prod_jd = sum(j_vec[k] * d_vec[k] for k in range(4 * log_n + 6 * log_g)) % p
        j_x, j_y, j_z = j_vec[-3], j_vec[-2], j_vec[-1]
        comm_c = poly_commit_vec(curve, params.gen_1.generators, [prod_jd], params.gen_1.h, rc,
                                 device=device)
        transcript.append_message(b"comm_c", point_bytes(curve, comm_c))
        c = challenge32(curve, transcript, b"challenge_nextround")
        z_vec = [
            (c * pie_vec[k] + d_vec[k]) % p for k in range(4 * log_n + 6 * log_g)
        ]
        z_delta_vec = [
            (c * r_alpha_vec[k] + r_delta_vec[k]) % p for k in range(log_n + 2 * log_g)
        ]
        zc = (c * ((rou_vec[0] * rc0 - j_x * rx - j_y * ry - j_z * rz) % p) + rc) % p
        return (
            (prod_proof, comm_x, comm_y, comm_z),
            comm_deltas, comm_c, z_vec, z_delta_vec, zc, [rx, ry],
        )

    # ------------------------- verifier -------------------------
    def verify(self, curve, params, comm_claim, u, q_vec, gates, n, ng, transcript,
               device="cuda"):
        p = curve.fr.modulus
        log_ng = ng.bit_length() - 1
        log_n = n.bit_length() - 1
        rs, r0, r1 = [], [], []
        for j in range(log_n + 2 * log_ng):
            comm_poly = self.comm_polys[j]
            comm_eval = self.comm_evals[j]
            transcript.append_message(b"comm_poly", point_bytes(curve, comm_poly))
            r_i = challenge32(curve, transcript, b"challenge_nextround")
            transcript.append_message(b"comm_claim_per_round", point_bytes(curve, comm_claim))
            transcript.append_message(b"comm_eval", point_bytes(curve, comm_eval))
            comm_claim = comm_eval
            if j < log_n:
                rs.append(r_i)
            elif j < log_n + log_ng:
                r0.append(r_i)
            else:
                r1.append(r_i)
        m_vec = construct_matrix((rs, r0, r1), q_vec, gates, u, log_n, log_ng, p)
        if not self._sigma_verify(curve, params, m_vec, log_ng, log_n, transcript, device):
            return None
        return self.comm_x, self.comm_y, rs, r0, r1

    def _sigma_verify(self, curve, params, m_vec, log_g, log_n, transcript,
                      device="cuda") -> bool:
        p = curve.fr.modulus
        g1 = curve.g1
        if not self.prod_proof.verify(
            curve, params.gen_1, self.comm_x, self.comm_y, self.comm_z, transcript, device=device
        ):
            return False
        for dc in self.comm_deltas:
            transcript.append_message(b"comm_delta", point_bytes(curve, dc))
        rou_vec = [
            challenge32(curve, transcript, b"challenge_nextround")
            for _ in range(log_n + 2 * log_g + 1)
        ]
        transcript.append_message(b"comm_c", point_bytes(curve, self.comm_c))
        c = challenge32(curve, transcript, b"challenge_nextround")
        for j in range(log_n + 2 * log_g):
            right = g1.add(g1.mul(self.comm_polys[j], c), self.comm_deltas[j])
            if j < log_n:
                left = poly_commit_vec(
                    curve, params.gen_4.generators,
                    self.z_vec[j * 4 : j * 4 + 4], params.gen_4.h, self.z_delta_vec[j],
                    device=device,
                )
            else:
                left = poly_commit_vec(
                    curve, params.gen_3.generators,
                    self.z_vec[log_n + j * 3 : log_n + j * 3 + 3],
                    params.gen_3.h, self.z_delta_vec[j], device=device,
                )
            if left != right:
                return False
        ncols = 4 * log_n + 6 * log_g + 3
        j_vec = [
            sum(rou_vec[jj] * m_vec[jj][k] for jj in range(log_n + 2 * log_g + 1)) % p
            for k in range(ncols)
        ]
        left_pt = g1.mul(self.comm_a0, rou_vec[0])
        left_pt = g1.add(left_pt, g1.mul(self.comm_x, (-j_vec[-3]) % p))
        left_pt = g1.add(left_pt, g1.mul(self.comm_y, (-j_vec[-2]) % p))
        left_pt = g1.add(left_pt, g1.mul(self.comm_z, (-j_vec[-1]) % p))
        left_pt = g1.add(g1.mul(left_pt, c), self.comm_c)
        prod_jz = sum(j_vec[k] * self.z_vec[k] for k in range(4 * log_n + 6 * log_g)) % p
        right_pt = poly_commit_vec(
            curve, params.gen_1.generators, [prod_jz], params.gen_1.h, self.zc, device=device
        )
        return left_pt == right_pt

"""Hyrax parameters and the sigma-protocol commitment suite.

Port of the reference's `schemes/hyrax/params.py` (parity: ckb-zkp
hyrax/src/{params.rs, commitment.rs}; the suite the reference duplicates
between libra and hyrax lives here once), word for word but for the
device: `Parameters.new` takes `device` (default "cuda") and makes its
`gen_n` list, the reference's random points from the same scalars drawn in
the same order, as one `generator_multiples` there; the sigma protocols'
provers and verifiers take `device` down to `poly_commit_vec` (a device
MSM from FIXED_BASE_MSM_MIN scalars up). `BulletReduceProof` keeps its
host `g1.msm`/`g1.mul` calls, as the reference does.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ...host.curves import AffinePoint
from ...host.pairing import PairingCurve
from ...serialize.tobytes import point_bytes
from ...transcript import Transcript
from ..spartan.common import (
    MultiCommitmentParameters,
    PolyCommitmentParameters,
    challenge_fr,
    poly_commit_vec,
)
from ..spartan.polynomial import eval_eq


def _rand_point(curve, rng):
    return curve.g1.mul(curve.g1_gen, rng.randrange(1, curve.fr.modulus))


def _multi_params(curve, rng, n):
    return MultiCommitmentParameters(
        n, [_rand_point(curve, rng) for _ in range(n)], _rand_point(curve, rng)
    )


@dataclass
class SumCheckCommitmentSetupParameters:
    gen_1: MultiCommitmentParameters
    gen_3: MultiCommitmentParameters
    gen_4: MultiCommitmentParameters


@dataclass
class Parameters:
    curve: PairingCurve
    pc_params: PolyCommitmentParameters
    sc_params: SumCheckCommitmentSetupParameters

    @classmethod
    def new(cls, curve: PairingCurve, rng: random.Random, num: int,
            device="cuda") -> "Parameters":
        from ...ops.msm import generator_multiples

        n = 1 << (num - num // 2)
        # _multi_params(curve, rng, n): the n generators' scalars, then h's,
        # drawn in the reference's order; the generators as one
        # `generator_multiples` on `device`
        r = curve.fr.modulus
        gens = generator_multiples(curve, [rng.randrange(1, r) for _ in range(n)], device)
        gen_n = MultiCommitmentParameters(n, gens, _rand_point(curve, rng))
        gen_1 = MultiCommitmentParameters(1, [_rand_point(curve, rng)], gen_n.h)
        pc = PolyCommitmentParameters(n, gen_n, gen_1)
        sc = SumCheckCommitmentSetupParameters(
            gen_1=MultiCommitmentParameters(1, list(pc.gen_1.generators), pc.gen_1.h),
            gen_3=_multi_params(curve, rng, 3),
            gen_4=_multi_params(curve, rng, 4),
        )
        return cls(curve=curve, pc_params=pc, sc_params=sc)

    def param_to_hash(self) -> int:
        curve = self.curve
        t = Transcript(b"hyrax - param_to_hash")
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
        return challenge_fr(curve, t, b"challenge_nextround")


# ---------------- sigma protocols (hyrax flavour) ----------------
def challenge32(curve, transcript, label: bytes) -> int:
    return int.from_bytes(transcript.challenge_bytes(label, 32)[:31], "little") % (
        curve.fr.modulus
    )


@dataclass
class EqProof:
    alpha: AffinePoint
    z: int

    @classmethod
    def prover(cls, curve, gen, claim1, blind1, claim2, blind2, rng, transcript,
               device="cuda"):
        p = curve.fr.modulus
        r = rng.randrange(p)
        c1 = poly_commit_vec(curve, gen.generators, [claim1], gen.h, blind1, device=device)
        transcript.append_message(b"C1", point_bytes(curve, c1))
        c2 = poly_commit_vec(curve, gen.generators, [claim2], gen.h, blind2, device=device)
        transcript.append_message(b"C2", point_bytes(curve, c2))
        alpha = curve.g1.mul(gen.h, r)
        transcript.append_message(b"alpha", point_bytes(curve, alpha))
        c = challenge32(curve, transcript, b"c")  # 32-byte buf (commitment.rs:35)
        return cls(alpha, (c * ((blind1 - blind2) % p) + r) % p)

    def verify(self, curve, gen, comm1, comm2, transcript, device="cuda") -> bool:
        g1 = curve.g1
        transcript.append_message(b"C1", point_bytes(curve, comm1))
        transcript.append_message(b"C2", point_bytes(curve, comm2))
        transcript.append_message(b"alpha", point_bytes(curve, self.alpha))
        c = challenge32(curve, transcript, b"c")
        comm = g1.sub(comm1, comm2)
        return g1.mul(gen.h, self.z) == g1.add(g1.mul(comm, c), self.alpha)


@dataclass
class ProductProof:
    comm_alpha: AffinePoint
    comm_beta: AffinePoint
    comm_delta: AffinePoint
    z: list[int]

    @classmethod
    def prover(cls, curve, gen, x, rx, y, ry, prod, rz, rng, transcript, device="cuda"):
        p = curve.fr.modulus
        comm_x = poly_commit_vec(curve, gen.generators, [x], gen.h, rx, device=device)
        transcript.append_message(b"X", point_bytes(curve, comm_x))
        comm_y = poly_commit_vec(curve, gen.generators, [y], gen.h, ry, device=device)
        transcript.append_message(b"Y", point_bytes(curve, comm_y))
        comm_prod = poly_commit_vec(curve, gen.generators, [prod], gen.h, rz, device=device)
        transcript.append_message(b"Z", point_bytes(curve, comm_prod))
        b1, b2, b3, b4, b5 = (rng.randrange(p) for _ in range(5))
        comm_alpha = poly_commit_vec(curve, gen.generators, [b1], gen.h, b2, device=device)
        transcript.append_message(b"alpha", point_bytes(curve, comm_alpha))
        comm_beta = poly_commit_vec(curve, gen.generators, [b3], gen.h, b4, device=device)
        transcript.append_message(b"beta", point_bytes(curve, comm_beta))
        comm_delta = poly_commit_vec(curve, [comm_x], [b3], gen.h, b5, device=device)
        transcript.append_message(b"delta", point_bytes(curve, comm_delta))
        c = int.from_bytes(transcript.challenge_bytes(b"c", 31), "little") % p
        z = [
            (b1 + c * x) % p,
            (b2 + c * rx) % p,
            (b3 + c * y) % p,
            (b4 + c * ry) % p,
            (b5 + c * ((rz - rx * y) % p)) % p,
        ]
        return cls(comm_alpha, comm_beta, comm_delta, z), comm_x, comm_y, comm_prod

    def verify(self, curve, gen, comm_x, comm_y, comm_prod, transcript,
               device="cuda") -> bool:
        p = curve.fr.modulus
        g1 = curve.g1
        z1, z2, z3, z4, z5 = self.z
        transcript.append_message(b"X", point_bytes(curve, comm_x))
        transcript.append_message(b"Y", point_bytes(curve, comm_y))
        transcript.append_message(b"Z", point_bytes(curve, comm_prod))
        transcript.append_message(b"alpha", point_bytes(curve, self.comm_alpha))
        transcript.append_message(b"beta", point_bytes(curve, self.comm_beta))
        transcript.append_message(b"delta", point_bytes(curve, self.comm_delta))
        c = int.from_bytes(transcript.challenge_bytes(b"c", 31), "little") % p
        ok1 = g1.add(self.comm_alpha, g1.mul(comm_x, c)) == poly_commit_vec(
            curve, gen.generators, [z1], gen.h, z2, device=device
        )
        ok2 = g1.add(self.comm_beta, g1.mul(comm_y, c)) == poly_commit_vec(
            curve, gen.generators, [z3], gen.h, z4, device=device
        )
        ok3 = g1.add(self.comm_delta, g1.mul(comm_prod, c)) == poly_commit_vec(
            curve, [comm_x], [z3], gen.h, z5, device=device
        )
        return ok1 and ok2 and ok3


@dataclass
class BulletReduceProof:
    l_vec: list[AffinePoint]
    r_vec: list[AffinePoint]

    @classmethod
    def prover(cls, curve, params: PolyCommitmentParameters, a_vec, b_vec,
               blind_gamma, blind_vec, transcript):
        p = curve.fr.modulus
        g1 = curve.g1
        n = len(a_vec)
        g_vec = list(params.gen_n.generators[:n])
        q = params.gen_1.generators[0]
        h = params.gen_1.h
        a_vec, b_vec = list(a_vec), list(b_vec)
        l_out, r_out = [], []
        blind_fin = blind_gamma
        it = iter(blind_vec)
        while n > 1:
            n //= 2
            al, ar = a_vec[:n], a_vec[n:]
            bl, br = b_vec[:n], b_vec[n:]
            gl, gr = g_vec[:n], g_vec[n:]
            cl = sum(x * y % p for x, y in zip(al, br)) % p
            cr = sum(x * y % p for x, y in zip(ar, bl)) % p
            blind_l, blind_r = next(it)
            L = g1.add(g1.msm(gr[:n], al), g1.add(g1.mul(q, cl), g1.mul(h, blind_l)))
            R = g1.add(g1.msm(gl, ar), g1.add(g1.mul(q, cr), g1.mul(h, blind_r)))
            l_out.append(L)
            r_out.append(R)
            transcript.append_message(b"L", point_bytes(curve, L))
            transcript.append_message(b"R", point_bytes(curve, R))
            x = int.from_bytes(transcript.challenge_bytes(b"x", 31), "little") % p
            x_inv = pow(x, -1, p)
            g_vec = [g1.add(g1.mul(gl[i], x_inv), g1.mul(gr[i], x)) for i in range(n)]
            a_vec = [(al[i] * x + ar[i] * x_inv) % p for i in range(n)]
            b_vec = [(bl[i] * x_inv + br[i] * x) % p for i in range(n)]
            blind_fin = (blind_fin + x * x % p * blind_l + x_inv * x_inv % p * blind_r) % p
        a, b, g = a_vec[0], b_vec[0], g_vec[0]
        gamma_hat = g1.add(
            g1.add(g1.mul(g, a), g1.mul(q, a * b % p)), g1.mul(h, blind_fin)
        )
        return cls(l_out, r_out), gamma_hat, a, b, g, blind_fin

    def verify(self, curve, g_vec, gamma, b_vec, transcript):
        p = curve.fr.modulus
        g1 = curve.g1
        lg_n = len(self.l_vec)
        n = 1 << lg_n
        x_sq, x_inv_sq = [], []
        allinv = 1
        for i in range(lg_n):
            transcript.append_message(b"L", point_bytes(curve, self.l_vec[i]))
            transcript.append_message(b"R", point_bytes(curve, self.r_vec[i]))
            x = int.from_bytes(transcript.challenge_bytes(b"x", 31), "little") % p
            x_inv = pow(x, -1, p)
            x_sq.append(x * x % p)
            x_inv_sq.append(x_inv * x_inv % p)
            allinv = allinv * x_inv % p
        s = [allinv]
        for i in range(1, n):
            lg_i = i.bit_length() - 1
            k = 1 << lg_i
            s.append(s[i - k] * x_sq[(lg_n - 1) - lg_i] % p)
        b_s = sum(b * si % p for b, si in zip(b_vec, s)) % p
        g_hat = g1.msm(list(g_vec[: len(s)]), s)
        gamma_hat = g1.add(
            g1.add(g1.msm(self.l_vec, x_sq), g1.msm(self.r_vec, x_inv_sq)), gamma
        )
        return b_s, g_hat, gamma_hat


@dataclass
class LogDotProductProof:
    bullet_reduce_proof: BulletReduceProof
    delta: AffinePoint
    beta: AffinePoint
    z1: int
    z2: int

    @classmethod
    def prover(cls, curve, params, x_vec, blind_x, a_vec, y, blind_y, rng, transcript,
               device="cuda"):
        p = curve.fr.modulus
        g1 = curve.g1
        size = len(a_vec)
        d = rng.randrange(p)
        r_beta = rng.randrange(p)
        r_delta = rng.randrange(p)
        blind_vec = [
            (rng.randrange(p), rng.randrange(p))
            for _ in range(max(0, (size - 1).bit_length()))
        ]
        comm_x = poly_commit_vec(curve, params.gen_n.generators, x_vec, params.gen_n.h, blind_x,
                                 device=device)
        transcript.append_message(b"Cx", point_bytes(curve, comm_x))
        comm_y = poly_commit_vec(curve, params.gen_1.generators, [y], params.gen_1.h, blind_y,
                                 device=device)
        transcript.append_message(b"Cy", point_bytes(curve, comm_y))
        blind_gamma = (blind_x + blind_y) % p
        brp, _gamma_hat, x_hat, a_hat, g_hat, r_hat_gamma = BulletReduceProof.prover(
            curve, params, x_vec, a_vec, blind_gamma, blind_vec, transcript
        )
        y_hat = x_hat * a_hat % p
        delta = poly_commit_vec(curve, [g_hat], [d], params.gen_1.h, r_delta, device=device)
        transcript.append_message(b"delta", point_bytes(curve, delta))
        beta = poly_commit_vec(curve, params.gen_1.generators, [d], params.gen_1.h, r_beta,
                               device=device)
        transcript.append_message(b"beta", point_bytes(curve, beta))
        c = int.from_bytes(transcript.challenge_bytes(b"c", 31), "little") % p
        z1 = (d + c * y_hat) % p
        z2 = (a_hat * ((c * r_hat_gamma + r_beta) % p) + r_delta) % p
        return cls(brp, delta, beta, z1, z2), comm_x, comm_y

    def verify(self, curve, params, comm_x, comm_y, a_vec, transcript,
               device="cuda") -> bool:
        p = curve.fr.modulus
        g1 = curve.g1
        transcript.append_message(b"Cx", point_bytes(curve, comm_x))
        transcript.append_message(b"Cy", point_bytes(curve, comm_y))
        gamma = g1.add(comm_x, comm_y)
        a_hat, g_hat, gamma_hat = self.bullet_reduce_proof.verify(
            curve, params.gen_n.generators, gamma, a_vec, transcript
        )
        transcript.append_message(b"delta", point_bytes(curve, self.delta))
        transcript.append_message(b"beta", point_bytes(curve, self.beta))
        c = int.from_bytes(transcript.challenge_bytes(b"c", 31), "little") % p
        lhs = g1.add(
            g1.mul(g1.add(g1.mul(gamma_hat, c), self.beta), a_hat), self.delta
        )
        rhs = g1.add(
            g1.mul(g1.add(g_hat, g1.mul(params.gen_1.generators[0], a_hat)), self.z1),
            g1.mul(params.gen_1.h, self.z2),
        )
        return lhs == rhs

    @classmethod
    def reduce_prover(cls, curve, params, poly, blind_poly, ry, ry_blind, eval_v, rng,
                      transcript, device="cuda"):
        p = curve.fr.modulus
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
        proof, _, comm_y = cls.prover(
            curve, params, lz, lz_blind, r_eq, eval_v, ry_blind, rng, transcript, device
        )
        return proof, comm_y

    def reduce_verifier(self, curve, params, ry, comms_witness, comm_ry, transcript,
                        device="cuda") -> bool:
        p = curve.fr.modulus
        size = len(ry)
        l_eq = eval_eq(ry[: size // 2], p)
        r_eq = eval_eq(ry[size // 2 :], p)
        comm_lz = poly_commit_vec(curve, comms_witness, l_eq, params.gen_1.h, 0, device=device)
        return self.verify(curve, params, comm_lz, comm_ry, r_eq, transcript, device)

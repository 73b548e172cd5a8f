"""Spartan commitments, parameters, transcript helpers, bullet IPA.

Port of the reference's `schemes/spartan/common.py` (parity: ckb-zkp
spartan/src/{commitments.rs, setup.rs, data_structure.rs,
inner_product.rs}), word for word but for the device: the Pedersen
commitments take `device` (default "cuda") down to `msm_over_fixed_base`,
and the packing commitment's rows, which all MSM over one generator list,
run as one `msm_over_fixed_base_many` (one batch of window rows and one
fold on the device, where the reference makes one MSM a row; the same
points, and the same blinds drawn in the same order).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from ...host.curves import AffinePoint
from ...host.pairing import PairingCurve
from ...serialize.tobytes import fr_bytes, point_bytes
from ...transcript import Transcript


def rb_fr(p: int, data: bytes) -> int:
    return int.from_bytes(data, "little") % p


def challenge_fr(curve, transcript: Transcript, label: bytes) -> int:
    return rb_fr(curve.fr.modulus, transcript.challenge_bytes(label, 31))


@dataclass
class MultiCommitmentParameters:
    n: int
    generators: list[AffinePoint]
    h: AffinePoint


@dataclass
class PolyCommitmentParameters:
    n: int
    gen_n: MultiCommitmentParameters
    gen_1: MultiCommitmentParameters


@dataclass
class SumCheckCommitmentParameters:
    gen_1: MultiCommitmentParameters
    gen_3: MultiCommitmentParameters
    gen_4: MultiCommitmentParameters


@dataclass
class R1CSSatisfiedParameters:
    pc_params: PolyCommitmentParameters
    sc_params: SumCheckCommitmentParameters
    n: int


@dataclass
class NizkParameters:
    r1cs_satisfied_params: R1CSSatisfiedParameters


def _rand_point(curve: PairingCurve, rng: random.Random) -> AffinePoint:
    return curve.g1.mul(curve.g1_gen, rng.randrange(1, curve.fr.modulus))


def poly_commitment_parameters(curve, rng, num: int, device="cuda") -> PolyCommitmentParameters:
    """The generators are `_rand_point`s, the same scalars drawn in the
    same order; the list's products with the generator run as one
    `generator_multiples` on `device` where it is long enough."""
    from ...ops.msm import generator_multiples

    n = 1 << (num - num // 2)
    r = curve.fr.modulus
    gens = generator_multiples(curve, [rng.randrange(1, r) for _ in range(n)], device)
    h = _rand_point(curve, rng)
    gen_n = MultiCommitmentParameters(n, gens, h)
    gen_1 = MultiCommitmentParameters(1, [_rand_point(curve, rng)], h)
    return PolyCommitmentParameters(n, gen_n, gen_1)


def sumcheck_commitment_parameters(curve, rng, gen_1) -> SumCheckCommitmentParameters:
    g3 = MultiCommitmentParameters(
        3, [_rand_point(curve, rng) for _ in range(3)], _rand_point(curve, rng)
    )
    g4 = MultiCommitmentParameters(
        4, [_rand_point(curve, rng) for _ in range(4)], _rand_point(curve, rng)
    )
    return SumCheckCommitmentParameters(gen_1, g3, g4)


def r1cs_satisfied_parameters(curve, rng, num_aux, num_inputs,
                              device="cuda") -> R1CSSatisfiedParameters:
    t = max(num_aux, num_inputs)
    tp = 1 if t == 0 else 1 << (t - 1).bit_length()
    n = tp.bit_length() - 1
    pc = poly_commitment_parameters(curve, rng, n, device)
    sc = sumcheck_commitment_parameters(curve, rng, pc.gen_1)
    return R1CSSatisfiedParameters(pc, sc, n)


def poly_commit_vec(curve, generators, values, h, blind, device="cuda") -> AffinePoint:
    """Pedersen commit; large batches run the device Pippenger over the
    cached encoded generator list (ops/msm.msm_over_fixed_base) on `device`."""
    from ...ops.msm import msm_over_fixed_base

    g1 = curve.g1
    return g1.add(msm_over_fixed_base(curve, generators, values, device=device),
                  g1.mul(h, blind))


def packing_poly_commit(curve, generators, values, h, rng, is_blind, device="cuda"):
    """sqrt-packing witness commitment (commitments.rs:10-40); the rows'
    MSMs run as one `msm_over_fixed_base_many` on `device`."""
    from ...ops.msm import msm_over_fixed_base_many

    p = curve.fr.modulus
    g1 = curve.g1
    n = len(values)
    size = (n - 1).bit_length() if n > 1 else 0
    l_size = 1 << (size // 2)
    r_size = 1 << (size - size // 2)
    assert n == l_size * r_size
    blinds = [rng.randrange(p) if is_blind else 0 for _ in range(l_size)]
    rows = [values[i * r_size : (i + 1) * r_size] for i in range(l_size)]
    msms = msm_over_fixed_base_many(curve, generators, rows, device=device)
    commits = [g1.add(m, g1.mul(h, blind)) for m, blind in zip(msms, blinds)]
    return commits, blinds


# ---------------- bullet inner product argument ----------------
@dataclass
class InnerProductProof:
    l_vec: list[AffinePoint]
    r_vec: list[AffinePoint]


def bullet_inner_product_proof(
    curve, g_vec, q, h, a_vec, b_vec, gamma_blind, blinds_vec, transcript
):
    p = curve.fr.modulus
    g1 = curve.g1
    a_vec, b_vec, g_vec = list(a_vec), list(b_vec), list(g_vec)
    n = len(a_vec)
    assert n & (n - 1) == 0 and n == len(b_vec)
    l_out, r_out = [], []
    blind_fin = gamma_blind
    it = iter(blinds_vec)
    while n > 1:
        n //= 2
        al, ar = a_vec[:n], a_vec[n:]
        bl, br = b_vec[:n], b_vec[n:]
        gl, gr = g_vec[:n], g_vec[n:]
        cl = sum(x * y % p for x, y in zip(al, br)) % p
        cr = sum(x * y % p for x, y in zip(ar, bl)) % p
        blind_l, blind_r = next(it)
        L = g1.add(g1.msm(gr, al), g1.add(g1.mul(q, cl), g1.mul(h, blind_l)))
        R = g1.add(g1.msm(gl, ar), g1.add(g1.mul(q, cr), g1.mul(h, blind_r)))
        l_out.append(L)
        r_out.append(R)
        transcript.append_message(b"L", point_bytes(curve, L))
        transcript.append_message(b"R", point_bytes(curve, R))
        x = challenge_fr(curve, transcript, b"x")
        x_inv = pow(x, -1, p)
        g_vec = [g1.add(g1.mul(gl[i], x_inv), g1.mul(gr[i], x)) for i in range(n)]
        a_vec = [(al[i] * x + ar[i] * x_inv) % p for i in range(n)]
        b_vec = [(bl[i] * x_inv + br[i] * x) % p for i in range(n)]
        blind_fin = (blind_fin + x * x % p * blind_l + x_inv * x_inv % p * blind_r) % p
    return (
        InnerProductProof(l_out, r_out),
        a_vec[0],
        b_vec[0],
        g_vec[0],
        blind_fin,
    )


def bullet_inner_product_verify(curve, g_vec, proof, gamma, b_vec, transcript):
    p = curve.fr.modulus
    g1 = curve.g1
    lg_n = len(proof.l_vec)
    n = 1 << lg_n
    x_sq, x_inv_sq = [], []
    allinv = 1
    for i in range(lg_n):
        transcript.append_message(b"L", point_bytes(curve, proof.l_vec[i]))
        transcript.append_message(b"R", point_bytes(curve, proof.r_vec[i]))
        x = challenge_fr(curve, transcript, b"x")
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
    g_hat = g1.msm(g_vec[: len(s)], s)
    gamma_hat = g1.add(
        g1.add(g1.msm(proof.l_vec, x_sq), g1.msm(proof.r_vec, x_inv_sq)), gamma
    )
    return b_s, g_hat, gamma_hat

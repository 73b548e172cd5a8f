"""Inner-product argument ("protocol2").

Port of the reference's `schemes/bulletproofs/inner_product_proof.py`
(parity: ckb-zkp bulletproofs/src/inner_product_proof.rs:22-174 —
log-size folding with the dalek-style s-vector verifier), word for word
but for the device: `prove` takes `device` (default "cuda") down to the
four `msm_over_fixed_base(..., cache=False)` calls of a round, which run
on it from FIXED_BASE_MSM_MIN scalars up. The folds of `g_vec`/`h_vec`
and `verify` stay host ints, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...host.curves import AffinePoint
from ...host.pairing import PairingCurve
from ...transcript import Transcript
from .common import (
    fr_bytes,
    inner_product,
    point_bytes,
    points_bytes,
    random_bytes_to_fr,
)


@dataclass
class Proof:
    L_vec: list[AffinePoint]
    R_vec: list[AffinePoint]
    a: int
    b: int


def _absorb_header(curve, transcript, n, u, P, g_vec, h_vec):
    transcript.append_u64(b"n", n)
    transcript.append_message(b"u", point_bytes(curve, u))
    transcript.append_message(b"P", point_bytes(curve, P))
    transcript.append_message(b"g_vec", points_bytes(curve, g_vec))
    transcript.append_message(b"h_vec", points_bytes(curve, h_vec))


def prove(
    curve: PairingCurve,
    transcript: Transcript,
    g_vec: list[AffinePoint],
    h_vec: list[AffinePoint],
    u: AffinePoint,
    P: AffinePoint,
    a_vec: list[int],
    b_vec: list[int],
    device="cuda",
) -> Proof:
    p = curve.fr.modulus
    g1 = curve.g1
    n = len(a_vec)
    assert n & (n - 1) == 0 and n == len(b_vec)
    _absorb_header(curve, transcript, n, u, P, g_vec, h_vec)

    from ...ops.msm import msm_over_fixed_base

    def msm(base, scalars):
        # device Pippenger above the size threshold; cache=False because the
        # half-slices are one-shot lists (inner_product_proof.rs:22-174)
        return msm_over_fixed_base(curve, base, scalars, cache=False, device=device)

    L_vec, R_vec = [], []
    while n > 1:
        n //= 2
        aL, aR = a_vec[:n], a_vec[n:]
        bL, bR = b_vec[:n], b_vec[n:]
        gL, gR = g_vec[:n], g_vec[n:]
        hL, hR = h_vec[:n], h_vec[n:]
        cL = inner_product(aL, bR, p)
        cR = inner_product(aR, bL, p)
        L = g1.add(g1.add(msm(gR, aL), msm(hL, bR)), g1.mul(u, cL))
        R = g1.add(g1.add(msm(gL, aR), msm(hR, bL)), g1.mul(u, cR))
        L_vec.append(L)
        R_vec.append(R)
        transcript.append_message(b"L", point_bytes(curve, L))
        transcript.append_message(b"R", point_bytes(curve, R))
        x = random_bytes_to_fr(p, transcript.challenge_bytes(b"x", 31))
        x_inv = pow(x, -1, p)
        g_vec = [g1.add(g1.mul(gL[i], x_inv), g1.mul(gR[i], x)) for i in range(n)]
        h_vec = [g1.add(g1.mul(hL[i], x), g1.mul(hR[i], x_inv)) for i in range(n)]
        a_vec = [(aL[i] * x + aR[i] * x_inv) % p for i in range(n)]
        b_vec = [(bL[i] * x_inv + bR[i] * x) % p for i in range(n)]
    return Proof(L_vec=L_vec, R_vec=R_vec, a=a_vec[0], b=b_vec[0])


def verify(
    curve: PairingCurve,
    transcript: Transcript,
    g_vec: list[AffinePoint],
    h_vec: list[AffinePoint],
    u: AffinePoint,
    P: AffinePoint,
    proof: Proof,
) -> bool:
    p = curve.fr.modulus
    g1 = curve.g1
    lg_n = len(proof.L_vec)
    n = 1 << lg_n
    _absorb_header(curve, transcript, n, u, P, g_vec, h_vec)

    x_sq, x_inv_sq = [], []
    allinv = 1
    for i in range(lg_n):
        transcript.append_message(b"L", point_bytes(curve, proof.L_vec[i]))
        transcript.append_message(b"R", point_bytes(curve, proof.R_vec[i]))
        x = random_bytes_to_fr(p, transcript.challenge_bytes(b"x", 31))
        x_inv = pow(x, -1, p)
        x_sq.append(x * x % p)
        x_inv_sq.append(x_inv * x_inv % p)
        allinv = allinv * x_inv % p
    # dalek s-vector
    s = [allinv]
    for i in range(1, n):
        lg_i = i.bit_length() - 1
        k = 1 << lg_i
        s.append(s[i - k] * x_sq[(lg_n - 1) - lg_i] % p)
    inv_s = s[::-1]
    a_s = [proof.a * si % p for si in s]
    b_s = [proof.b * si % p for si in inv_s]
    c_final = proof.a * proof.b % p
    lhs = g1.add(g1.add(g1.msm(g_vec, a_s), g1.msm(h_vec, b_s)), g1.mul(u, c_final))
    rhs = g1.add(
        g1.add(g1.msm(proof.L_vec, x_sq), g1.msm(proof.R_vec, x_inv_sq)), P
    )
    return lhs == rhs

"""KZG10 polynomial commitments (Marlin-flavoured, with optional hiding).

Port of the reference's `schemes/kzg10.py` (ckb-zkp
marlin/src/pc/kzg10.rs:27-226): setup/trim/commit/open/check with gamma_g
hiding powers. The SRS powers are two K6 fixed-base MSMs, every commitment
and opening is an RCB MSM (K2-K5) and the witness polynomial's synthetic
division runs on the device (`ops/poly.poly_divide_linear`); the pairing
check is the host O(1) path. `setup` takes the device; the later calls
take it from the key's tensors. The powers are affine-encoded (X, Y, Z)
tuples of (n, L) tensors, sliced as tuples where the reference maps
`jax.tree.map` over them.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any

from ..host.curves import AffinePoint
from ..host.pairing import PairingCurve
from ..ops.field import device_field
from ..ops.msm import device_group
from ..ops.poly import poly_divide_linear, poly_eval
from .errors import DegreeOutOfBound, HidingBoundError


def head(points, n: int, offset: int = 0):
    """Rows [offset, offset + n) of an (X, Y, Z) point array."""
    return tuple(c[offset : offset + n] for c in points)


@dataclass
class UniversalParams:
    curve: PairingCurve
    powers_of_g: Any  # device G1 affine-encoded arrays, len max_degree+1
    powers_of_gamma_g: Any  # device G1 affine-encoded arrays, len max_degree+1
    g: AffinePoint
    gamma_g: AffinePoint
    h: AffinePoint  # G2
    beta_h: AffinePoint  # G2

    @property
    def max_degree(self) -> int:
        return self.powers_of_g[0].shape[0] - 1


@dataclass
class CommitterKey:
    curve: PairingCurve
    powers_of_g: Any
    powers_of_gamma_g: Any
    supported_degree: int


@dataclass
class VerifierKey:
    curve: PairingCurve
    g: AffinePoint
    gamma_g: AffinePoint
    h: AffinePoint
    beta_h: AffinePoint
    supported_degree: int


@dataclass
class Rand:
    """Hiding randomness: blinding polynomial coefficients (host ints)."""

    blinding: list[int] = field(default_factory=list)

    @property
    def is_hiding(self) -> bool:
        return len(self.blinding) > 0


def setup(
    curve: PairingCurve, max_degree: int, rng: random.Random, device="cuda"
) -> UniversalParams:
    p = curve.fr.modulus
    beta = rng.randrange(1, p)
    g_s = rng.randrange(1, p)
    gamma_s = rng.randrange(1, p)
    h_s = rng.randrange(1, p)
    g = curve.g1.mul(curve.g1_gen, g_s)
    gamma_g = curve.g1.mul(curve.g1_gen, gamma_s)
    h = curve.g2.mul(curve.g2_gen, h_s)

    fr = device_field(curve.fr, device)
    dg1 = device_group(curve, "g1", device)
    powers_beta = fr.from_mont(fr.powers(beta, max_degree + 1))
    tg = dg1.fixed_base(g)
    tgamma = dg1.fixed_base(gamma_g)
    powers_of_g = dg1.fixed_base_msm(tg, powers_beta)
    powers_of_gamma_g = dg1.fixed_base_msm(tgamma, powers_beta)
    return UniversalParams(
        curve=curve,
        powers_of_g=powers_of_g,
        powers_of_gamma_g=powers_of_gamma_g,
        g=g,
        gamma_g=gamma_g,
        h=h,
        beta_h=curve.g2.mul(h, beta),
    )


def trim(pp: UniversalParams, supported_degree: int):
    if supported_degree > pp.max_degree:
        raise DegreeOutOfBound("trimming degree too large")
    ck = CommitterKey(
        curve=pp.curve,
        powers_of_g=head(pp.powers_of_g, supported_degree + 1),
        powers_of_gamma_g=head(pp.powers_of_gamma_g, supported_degree + 1),
        supported_degree=supported_degree,
    )
    vk = VerifierKey(
        curve=pp.curve,
        g=pp.g,
        gamma_g=pp.gamma_g,
        h=pp.h,
        beta_h=pp.beta_h,
        supported_degree=supported_degree,
    )
    return ck, vk


def _groups(ck: CommitterKey):
    device = ck.powers_of_g[0].device
    return device_field(ck.curve.fr, device), device_group(ck.curve, "g1", device)


def commit(
    ck: CommitterKey,
    coeffs,  # device (n, L) Montgomery
    hiding_bound: int | None = None,
    rng: random.Random | None = None,
) -> tuple[AffinePoint, Rand]:
    curve = ck.curve
    fr, dg1 = _groups(ck)
    n = coeffs.shape[0]
    if n - 1 > ck.supported_degree:
        raise DegreeOutOfBound(f"degree {n-1} > {ck.supported_degree}")
    comm_dev = dg1.msm(head(ck.powers_of_g, n), fr.from_mont(coeffs))
    comm = dg1.decode_point(comm_dev)
    rand = Rand()
    if hiding_bound is not None:
        if rng is None:
            raise HidingBoundError("missing rng for hiding commitment")
        if hiding_bound == 0:
            raise HidingBoundError("hiding bound is zero")
        p = curve.fr.modulus
        rand = Rand([rng.randrange(p) for _ in range(hiding_bound + 1)])
        bl = dg1.encode_scalars(rand.blinding)
        gg_slice = head(ck.powers_of_gamma_g, len(rand.blinding))
        blind_comm = dg1.decode_point(dg1.msm(gg_slice, bl))
        comm = curve.g1.add(comm, blind_comm)
    return comm, rand


@dataclass
class OpenProof:
    w: AffinePoint
    rand_v: int | None = None


def open_at(ck: CommitterKey, coeffs, point: int, rand: Rand) -> OpenProof:
    curve = ck.curve
    fr, dg1 = _groups(ck)
    q, _ = poly_divide_linear(fr, coeffs, point)
    w_dev = dg1.msm(head(ck.powers_of_g, q.shape[0]), fr.from_mont(q))
    w = dg1.decode_point(w_dev)
    rand_v = None
    if rand.is_hiding:
        bl = fr.encode(rand.blinding)
        qb, _ = poly_divide_linear(fr, bl, point)
        gg_slice = head(ck.powers_of_gamma_g, qb.shape[0])
        wb = dg1.decode_point(dg1.msm(gg_slice, fr.from_mont(qb)))
        w = curve.g1.add(w, wb)
        rand_v = fr.decode_scalar(poly_eval(fr, bl, point))
    return OpenProof(w=w, rand_v=rand_v)


def check(
    vk: VerifierKey, comm: AffinePoint, point: int, value: int, proof: OpenProof
) -> bool:
    curve = vk.curve
    g1, g2 = curve.g1, curve.g2
    u = g1.sub(comm, g1.mul(vk.g, value))
    if proof.rand_v is not None:
        u = g1.sub(u, g1.mul(vk.gamma_g, proof.rand_v))
    v = g2.sub(vk.beta_h, g2.mul(vk.h, point))
    # e(u, h) == e(w, beta_h - point*h)
    res = curve.product_of_pairings([(u, vk.h), (g1.neg(proof.w), v)])
    return res == curve.tower.ONE12

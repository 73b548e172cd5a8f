"""Marlin's labeled polynomial-commitment wrapper over KZG10.

Port of the reference's `schemes/marlin/pc.py` (ckb-zkp
marlin/src/pc/mod.rs + data_structures.rs): degree-bound shifted
commitments, combined single-point openings with challenge^2
progression, point-grouped batch open/check, with the same rng draws in
the same order. Every commitment is an RCB MSM over a tuple slice of the
key's affine-encoded powers, on the key's device; the coefficients go up
as canonical limbs (`encode_scalars`), where the reference encodes to
Montgomery form and converts back on the device. The MSMs of one `commit`
and of one `batch_open` run as one `DeviceCurveGroup.msm_many` (the
reference runs them one by one): the same points, and the window fold's
K5 launches are paid once a batch, not once an MSM.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ...host import poly as hpoly
from ...host.curves import AffinePoint
from ...host.pairing import PairingCurve
from ...ops.field import device_field
from ...ops.msm import device_group
from ...ops.poly import encode_ints, poly_divide_linear
from ...serialize.tobytes import point_bytes, u64_bytes
from .. import kzg10
from ..kzg10 import head
from ..errors import DegreeOutOfBound

UniversalParams = kzg10.UniversalParams
setup = kzg10.setup


@dataclass
class LabeledPolynomial:
    label: str
    coeffs: list[int]  # host ints, ascending
    degree_bound: int | None = None
    hiding_bound: int | None = None

    def degree(self) -> int:
        return hpoly.trim(self.coeffs).__len__() - 1

    def evaluate(self, x: int, p: int) -> int:
        return hpoly.evaluate(self.coeffs, x, p)


@dataclass
class Commitment:
    comm: AffinePoint
    shifted_comm: AffinePoint | None = None


@dataclass
class LabeledCommitment:
    label: str
    commitment: Commitment
    degree_bound: int | None = None


@dataclass
class Randomness:
    rand: list[int]
    shifted_rand: list[int] | None = None


@dataclass
class CommitterKey:
    curve: PairingCurve
    powers_of_g: object  # device G1 affine-encoded arrays
    powers_of_gamma_g: object
    supported_degree: int


@dataclass
class VerifierKey:
    curve: PairingCurve
    g: AffinePoint
    gamma_g: AffinePoint
    h: AffinePoint
    beta_h: AffinePoint
    supported_degree: int

    def to_bytes(self) -> bytes:
        c = self.curve
        return (
            point_bytes(c, self.g)
            + point_bytes(c, self.gamma_g)
            + point_bytes(c, self.h, "g2")
            + point_bytes(c, self.beta_h, "g2")
            + u64_bytes(self.supported_degree)
        )


def commitment_bytes(curve: PairingCurve, c: Commitment) -> bytes:
    out = point_bytes(curve, c.comm)
    if c.shifted_comm is not None:
        out += b"\x01" + point_bytes(curve, c.shifted_comm)
    else:
        out += b"\x00"
    return out


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


def _msm_slices(curve, slices) -> list[AffinePoint]:
    """The MSM over powers[offset : offset+len(coeffs)] with host
    coefficients of each (powers, coeffs, offset) of `slices`, all through
    one `msm_many` (the reference's `_msm_slice` one at a time)."""
    if not slices:
        return []
    dg1 = device_group(curve, "g1", slices[0][0][0].device)
    jobs = []
    for powers, coeffs, offset in slices:
        coeffs = hpoly.trim(list(coeffs))
        jobs.append((head(powers, len(coeffs), offset), dg1.encode_scalars(coeffs)))
    return [dg1.decode_point(q) for q in dg1.msm_many(jobs)]


def commit(
    ck: CommitterKey,
    polynomials: list[LabeledPolynomial],
    rng: random.Random | None,
) -> tuple[list[LabeledCommitment], list[Randomness]]:
    """As the reference, whose loop draws the hiding randomness and runs
    each MSM in turn; here the draws come first, in the same order, and
    the MSMs of all the polynomials then run as one `msm_many`."""
    curve = ck.curve
    p = curve.fr.modulus
    g1 = curve.g1
    rands, slices = [], []
    for lp in polynomials:
        if lp.degree() > ck.supported_degree:
            raise DegreeOutOfBound(lp.label)
        slices.append((ck.powers_of_g, lp.coeffs, 0))
        rand = Randomness(rand=[], shifted_rand=None)
        if lp.hiding_bound is not None:
            assert rng is not None
            rand.rand = [rng.randrange(p) for _ in range(lp.hiding_bound + 1)]
            slices.append((ck.powers_of_gamma_g, rand.rand, 0))
        if lp.degree_bound is not None:
            shift = ck.supported_degree - lp.degree_bound
            slices.append((ck.powers_of_g, lp.coeffs, shift))
            if lp.hiding_bound is not None:
                rand.shifted_rand = [
                    rng.randrange(p) for _ in range(lp.hiding_bound + 1)
                ]
                slices.append((ck.powers_of_gamma_g, rand.shifted_rand, 0))
            elif lp.hiding_bound is None:
                rand.shifted_rand = []
        rands.append(rand)
    msms = iter(_msm_slices(curve, slices))
    comms = []
    for lp in polynomials:
        comm = next(msms)
        if lp.hiding_bound is not None:
            comm = g1.add(comm, next(msms))
        shifted_comm = None
        if lp.degree_bound is not None:
            shifted_comm = next(msms)
            if lp.hiding_bound is not None:
                shifted_comm = g1.add(shifted_comm, next(msms))
        comms.append(
            LabeledCommitment(lp.label, Commitment(comm, shifted_comm), lp.degree_bound)
        )
    return comms, rands


def _witness(
    ck: CommitterKey,
    polynomials: list[LabeledPolynomial],
    randomnesses: list[Randomness],
    point: int,
    opening_challenge: int,
):
    """The reference's `open_at` up to its MSMs: the MSM jobs of the
    opening proof (the witness polynomial's quotient on the device, the
    hiding part's host quotient) and rand_v."""
    curve = ck.curve
    p = curve.fr.modulus
    fr = device_field(curve.fr, ck.powers_of_g[0].device)
    comb: list[int] = [0]
    comb_r: list[int] = [0]
    challenge = 1
    for lp, rand in zip(polynomials, randomnesses):
        comb = hpoly.add(comb, hpoly.scale(lp.coeffs, challenge, p), p)
        if rand.rand:
            comb_r = hpoly.add(comb_r, hpoly.scale(rand.rand, challenge, p), p)
        if lp.degree_bound is not None:
            shift = ck.supported_degree - lp.degree_bound
            shifted_challenge = challenge * opening_challenge % p
            shifted = [0] * shift + hpoly.trim(lp.coeffs)
            comb = hpoly.add(comb, hpoly.scale(shifted, shifted_challenge, p), p)
            if rand.shifted_rand:
                comb_r = hpoly.add(
                    comb_r, hpoly.scale(rand.shifted_rand, shifted_challenge, p), p
                )
        challenge = challenge * opening_challenge % p * opening_challenge % p
    # witness polynomial on device
    q, _ = poly_divide_linear(fr, encode_ints(fr, comb), point)
    jobs = [(head(ck.powers_of_g, q.shape[0]), fr.from_mont(q))]
    rand_v = None
    if hpoly.trim(comb_r) != [0]:
        qb, _ = hpoly.divmod_poly(comb_r, [(-point) % p, 1], p)
        qb = hpoly.trim(list(qb))
        dg1 = device_group(curve, "g1", fr.device)
        jobs.append((head(ck.powers_of_gamma_g, len(qb)), dg1.encode_scalars(qb)))
        rand_v = hpoly.evaluate(comb_r, point, p)
    return jobs, rand_v


def _open_many(ck: CommitterKey, openings) -> list[kzg10.OpenProof]:
    """The opening proof of each (polynomials, randomnesses, point,
    opening_challenge) of `openings`, their MSMs as one `msm_many`."""
    curve = ck.curve
    dg1 = device_group(curve, "g1", ck.powers_of_g[0].device)
    parts = [_witness(ck, *o) for o in openings]
    msms = iter(dg1.msm_many([job for jobs, _ in parts for job in jobs]))
    proofs = []
    for jobs, rand_v in parts:
        w = dg1.decode_point(next(msms))
        if len(jobs) > 1:
            w = curve.g1.add(w, dg1.decode_point(next(msms)))
        proofs.append(kzg10.OpenProof(w=w, rand_v=rand_v))
    return proofs


def open_at(
    ck: CommitterKey,
    polynomials: list[LabeledPolynomial],
    randomnesses: list[Randomness],
    point: int,
    opening_challenge: int,
) -> kzg10.OpenProof:
    return _open_many(ck, [(polynomials, randomnesses, point, opening_challenge)])[0]


def _accumulate(vk: VerifierKey, commitments, point, values, opening_challenge):
    curve = vk.curve
    p = curve.fr.modulus
    g1 = curve.g1
    acc_comm = g1.infinity
    acc_value = 0
    challenge = 1
    for lc, value in zip(commitments, values):
        c = lc.commitment
        acc_comm = g1.add(acc_comm, g1.mul(c.comm, challenge))
        acc_value = (acc_value + value * challenge) % p
        if lc.degree_bound is not None:
            shifted_challenge = challenge * opening_challenge % p
            shifted_degree = vk.supported_degree - lc.degree_bound
            shift_value = pow(point, shifted_degree, p) * value % p
            acc_comm = g1.add(acc_comm, g1.mul(c.shifted_comm, shifted_challenge))
            acc_value = (acc_value + shift_value * shifted_challenge) % p
        challenge = challenge * opening_challenge % p * opening_challenge % p
    return acc_comm, acc_value


def check(
    vk: VerifierKey, commitments, point, values, proof, opening_challenge
) -> bool:
    acc_comm, acc_value = _accumulate(vk, commitments, point, values, opening_challenge)
    kvk = kzg10.VerifierKey(
        curve=vk.curve,
        g=vk.g,
        gamma_g=vk.gamma_g,
        h=vk.h,
        beta_h=vk.beta_h,
        supported_degree=vk.supported_degree,
    )
    return kzg10.check(kvk, acc_comm, point, acc_value, proof)


def batch_open(
    ck: CommitterKey,
    polynomials: list[LabeledPolynomial],
    query_set: set[tuple[str, int]],
    opening_challenge: int,
    randomnesses: list[Randomness],
) -> list[kzg10.OpenProof]:
    by_label = {lp.label: (lp, r) for lp, r in zip(polynomials, randomnesses)}
    points: dict[int, list[str]] = {}
    for label, point in query_set:
        points.setdefault(point, []).append(label)
    openings = []
    for point in sorted(points):
        labels = sorted(points[point])
        polys = [by_label[l][0] for l in labels]
        rands = [by_label[l][1] for l in labels]
        openings.append((polys, rands, point, opening_challenge))
    return _open_many(ck, openings)


def batch_check(
    vk: VerifierKey,
    commitments: list[LabeledCommitment],
    query_set: set[tuple[str, int]],
    evaluations: dict[tuple[str, int], int],
    proofs: list[kzg10.OpenProof],
    opening_challenge: int,
) -> bool:
    by_label = {c.label: c for c in commitments}
    points: dict[int, list[str]] = {}
    for label, point in query_set:
        points.setdefault(point, []).append(label)
    if len(points) != len(proofs):
        return False
    ok = True
    for (point, labels_), proof in zip(
        ((pt, sorted(points[pt])) for pt in sorted(points)), proofs
    ):
        cs = [by_label[l] for l in labels_]
        vs = [evaluations[(l, point)] for l in labels_]
        ok &= check(vk, cs, point, vs, proof, opening_challenge)
    return ok

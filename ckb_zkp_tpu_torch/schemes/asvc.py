"""aSVC: aggregatable subvector commitments (KZG over the Lagrange basis).

Port of the reference's `schemes/asvc.py` (ckb-zkp asvc/src/lib.rs:33-439
— key_gen / commit / prove_pos / verify_pos / verify_upk / update_commit /
update_proof / aggregate_proofs, the same key structure: per-position
update keys a_i, u_i and Lagrange commitments l_i). `key_gen` takes the
device; the other calls take it from the parameters' tensors. Device work:
the tau- and omega-power tables, the fixed-base MSMs (K6, K1), the
value->polynomial iNTT and the O(log n)-launch linear divisions of the
witness polynomial (`ops/poly.poly_divide_linear`), and the variable MSMs
(K2-K5). The reference's `jax.tree.map` slices are `kzg10.head` slices of
the (X, Y, Z) tensors.

Two steps of `key_gen` compute the reference's values another way:
`powers_of_g2` (a host G2 scalar multiplication a power in the reference,
hours at 2^20) is the G2 fixed-base MSM over the same tau powers, decoded
to the same host points; `denom` (a host `pow(omega, i, p)` a position)
is tau minus the device's omega powers. Position-subset algebra (A_I,
partial fractions) is tiny and stays on the host.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ..host import poly as hpoly
from ..host.curves import AffinePoint
from ..host.pairing import PairingCurve
from ..ops.field import device_field
from ..ops.msm import device_group
from ..ops.ntt import get_domain
from ..ops.poly import encode_ints, poly_divide_linear
from .groth16.prover import Stages
from .kzg10 import head


@dataclass
class UpdateKey:
    ai: AffinePoint
    ui: AffinePoint


@dataclass
class ProvingKey:
    powers_of_g1: object  # device G1 points, len n+1
    l_of_g1: object  # device G1 points, len n (Lagrange commitments)
    update_keys: list[UpdateKey]


@dataclass
class VerificationKey:
    powers_of_g1: object  # device G1 points, len n+1
    powers_of_g2: list[AffinePoint]  # host, len n+1
    a: AffinePoint  # g1^(tau^n - 1)


@dataclass
class Parameters:
    curve: PairingCurve
    proving_key: ProvingKey
    verification_key: VerificationKey
    n: int
    omega: int


@dataclass
class Commitment:
    commit: AffinePoint


@dataclass
class Proof:
    w: AffinePoint


def _groups(params: Parameters):
    device = params.proving_key.powers_of_g1[0].device
    curve = params.curve
    return device_field(curve.fr, device), device_group(curve, "g1", device)


def key_gen(
    curve: PairingCurve, n: int, rng: random.Random, device="cuda",
    timings: dict | None = None,
) -> Parameters:
    """`timings`, when given, receives the seconds of the stages: the tau
    powers, the window tables (`tables`), the G1 and G2 powers' fixed-base
    MSMs, the G2 powers' decode, the update keys' scalars, fixed-base MSMs
    and decode."""
    st = Stages(timings, device)
    p = curve.fr.modulus
    fr = device_field(curve.fr, device)
    dom = get_domain(curve.fr, n, device)
    size = dom.n
    tau = rng.randrange(1, p)
    if pow(tau, size, p) == 1:
        raise ValueError("tau in evaluation domain; resample")
    g1 = curve.g1.mul(curve.g1_gen, rng.randrange(1, p))
    g2 = curve.g2.mul(curve.g2_gen, rng.randrange(1, p))

    dg1 = device_group(curve, "g1", device)
    dg2 = device_group(curve, "g2", device)
    taus = fr.from_mont(fr.powers(tau, size + 1))
    st.mark("tau_powers")
    t1 = dg1.fixed_base_table(g1)
    t2 = dg2.fixed_base_table(g2)
    st.mark("tables")
    powers_of_g1 = dg1.fixed_base_msm(t1, taus)
    st.mark("fixed_base_g1_powers")
    g2_query = dg2.fixed_base_msm(t2, taus)
    st.mark("fixed_base_g2_powers")
    powers_of_g2 = dg2.decode_points(g2_query)
    del g2_query
    st.mark("decode_g2_powers")

    a_point = curve.g1.mul(g1, (pow(tau, size, p) - 1) % p)

    # per-position keys: a_i = g1^(A(tau)/(tau - w^i)), l_i = a_i^(w^i / n),
    # u_i = (l_i - g1)^(1/(tau - w^i))   — batched as three fixed-base MSMs
    omega = dom.omega
    a_tau = (pow(tau, size, p) - 1) % p
    n_inv = pow(size, -1, p)
    omegas = fr.powers(omega, size)
    denom = fr.sub(fr.const(tau, (1,)), omegas)
    denom_inv = fr.batch_inv(denom)
    ai_s = fr.mul(denom_inv, fr.const(a_tau, (1,)))
    wi_over_n = fr.mul(omegas, fr.const(n_inv, (1,)))
    li_s = fr.mul(ai_s, wi_over_n)
    ui_s = fr.mul(fr.sub(li_s, fr.ones((size,))), denom_inv)
    st.mark("update_scalars")
    ai_query = dg1.fixed_base_msm(t1, fr.from_mont(ai_s))
    li_query = dg1.fixed_base_msm(t1, fr.from_mont(li_s))
    ui_query = dg1.fixed_base_msm(t1, fr.from_mont(ui_s))
    st.mark("fixed_base_update_keys")
    ai_pts = dg1.decode_points(ai_query)
    ui_pts = dg1.decode_points(ui_query)
    update_keys = [UpdateKey(ai=a, ui=u) for a, u in zip(ai_pts, ui_pts)]
    st.mark("decode_update_keys")

    return Parameters(
        curve=curve,
        proving_key=ProvingKey(
            powers_of_g1=powers_of_g1, l_of_g1=li_query, update_keys=update_keys
        ),
        verification_key=VerificationKey(
            powers_of_g1=powers_of_g1, powers_of_g2=powers_of_g2, a=a_point
        ),
        n=size,
        omega=omega,
    )


def commit(params: Parameters, values: list[int]) -> Commitment:
    _, dg1 = _groups(params)
    assert 1 <= len(values) <= params.n
    pts = head(params.proving_key.l_of_g1, len(values))
    return Commitment(dg1.decode_point(dg1.msm(pts, dg1.encode_scalars(values))))


def prove_pos(params: Parameters, values: list[int], points: list[int]) -> Proof:
    curve = params.curve
    p = curve.fr.modulus
    fr, dg1 = _groups(params)
    dom = get_domain(curve.fr, params.n, fr.device)
    vals = list(values) + [0] * (params.n - len(values))
    phi = dom.intt(encode_ints(fr, vals))
    # divide by prod (x - w^i): sequential exact linear divisions on device
    q = phi
    for pt in points:
        q, _ = poly_divide_linear(fr, q, pow(params.omega, pt, p))
    pts = head(params.proving_key.powers_of_g1, q.shape[0])
    w = dg1.decode_point(dg1.msm(pts, fr.from_mont(q)))
    return Proof(w)


def verify_pos(
    params: Parameters,
    commitment: Commitment,
    point_values: list[int],
    points: list[int],
    proof: Proof,
) -> bool:
    curve = params.curve
    p = curve.fr.modulus
    _, dg1 = _groups(params)
    vk = params.verification_key
    omegas = [pow(params.omega, pt, p) for pt in points]
    a_poly = hpoly.from_roots(omegas, p)
    # r(x) = sum_i v_i * A_I(x) / (A_I'(w^i) (x - w^i))
    r_poly = [0]
    for w_i, v in zip(omegas, point_values):
        l_poly, _ = hpoly.divmod_poly(a_poly, [(-w_i) % p, 1], p)
        b = hpoly.evaluate(l_poly, w_i, p)
        r_poly = hpoly.add(r_poly, hpoly.scale(l_poly, v * pow(b, -1, p) % p, p), p)
    g1pts = head(vk.powers_of_g1, len(r_poly))
    r_value = dg1.decode_point(dg1.msm(g1pts, dg1.encode_scalars(r_poly)))
    inner = curve.g1.sub(commitment.commit, r_value)
    # A_I at tau in G2 (host MSM over the few powers)
    a_value = curve.g2.msm(vk.powers_of_g2[: len(a_poly)], a_poly)
    # e(C - r, g2) == e(w, A_I(tau) in G2)
    res = curve.product_of_pairings(
        [(inner, vk.powers_of_g2[0]), (curve.g1.neg(proof.w), a_value)]
    )
    return res == curve.tower.ONE12


def verify_upk(params: Parameters, point: int, upk: UpdateKey) -> bool:
    curve = params.curve
    p = curve.fr.modulus
    vk = params.verification_key
    omega_i = pow(params.omega, point, p)
    inner = curve.g2.sub(vk.powers_of_g2[1], curve.g2.mul(vk.powers_of_g2[0], omega_i))
    ok1 = curve.product_of_pairings(
        [(upk.ai, inner), (curve.g1.neg(vk.a), vk.powers_of_g2[0])]
    ) == curve.tower.ONE12
    coeff = omega_i * pow(params.n, -1, p) % p
    l_value = curve.g1.mul(upk.ai, coeff)
    # decode g1 = powers_of_g1[0]
    _, dg1 = _groups(params)
    g1_0 = dg1.decode_points(head(vk.powers_of_g1, 1))[0]
    inner2 = curve.g1.sub(l_value, g1_0)
    ok2 = curve.product_of_pairings(
        [(inner2, vk.powers_of_g2[0]), (curve.g1.neg(upk.ui), inner)]
    ) == curve.tower.ONE12
    return ok1 and ok2


def update_commit(
    params: Parameters, commitment: Commitment, delta: int, point: int, upk: UpdateKey
) -> Commitment:
    curve = params.curve
    p = curve.fr.modulus
    coeff = pow(params.omega, point, p) * pow(params.n, -1, p) % p
    l_value = curve.g1.mul(upk.ai, coeff)
    return Commitment(curve.g1.add(commitment.commit, curve.g1.mul(l_value, delta)))


def update_proof(
    params: Parameters,
    proof: Proof,
    delta: int,
    point_i: int,
    point_j: int,
    upk_i: UpdateKey,
    upk_j: UpdateKey,
) -> Proof:
    curve = params.curve
    p = curve.fr.modulus
    g1 = curve.g1
    if point_i == point_j:
        return Proof(g1.add(proof.w, g1.mul(upk_i.ui, delta)))
    omega_i = pow(params.omega, point_i, p)
    omega_j = pow(params.omega, point_j, p)
    c1 = pow((omega_j - omega_i) % p, -1, p)
    c2 = pow((omega_i - omega_j) % p, -1, p)
    w_ij = g1.add(g1.mul(upk_j.ai, c1), g1.mul(upk_i.ai, c2))
    coeff = omega_j * pow(params.n, -1, p) % p
    u_ij = g1.mul(w_ij, coeff)
    return Proof(g1.add(proof.w, g1.mul(u_ij, delta)))


def aggregate_proofs(params: Parameters, points: list[int], proofs: list[Proof]) -> Proof:
    curve = params.curve
    p = curve.fr.modulus
    omegas = [pow(params.omega, pt, p) for pt in points]
    a_poly = hpoly.from_roots(omegas, p)
    agg = curve.g1.infinity
    for w_i, proof in zip(omegas, proofs):
        a_aside, _ = hpoly.divmod_poly(a_poly, [(-w_i) % p, 1], p)
        c = pow(hpoly.evaluate(a_aside, w_i, p), -1, p)
        agg = curve.g1.add(agg, curve.g1.mul(proof.w, c))
    return Proof(agg)

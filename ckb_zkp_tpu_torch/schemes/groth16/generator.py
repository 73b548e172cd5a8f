"""Groth16 trusted setup on torch, restricted to what the prover needs.

Port of the reference's `generate_parameters_from_shape`
(`schemes/groth16/generator.py:47-185`). The instance map u_i(t), v_i(t),
w_i(t) and the scalar algebra of `_setup_scalars` (`:113-142`) run in host
ints; the five query vectors are fixed-base MSMs (`ops/msm.py`); the
verifying key is built in host ints. The output has the reference's
device-setup layout (`padded_queries=True`): a, b_g1 and l queries padded
to the aligned column count (l is infinity at input slots), h padded to
max(columns, m) with infinity from m - 1 up, b_g2 pow2-padded.
"""

from __future__ import annotations

from ..._reference import Parameters, VerifyKey
from ...ops.msm import device_group
from .prover import Stages
from .qap import qap_matrices


def generate_parameters_from_shape(shape, curve, alpha: int, beta: int,
                                   gamma: int, delta: int, t: int,
                                   device="cpu", timings: dict | None = None):
    mark = Stages(timings, device).mark
    p = curve.fr.modulus
    qap = qap_matrices(shape, curve.fr, device)
    zt = (pow(t, qap.m, p) - 1) % p
    if zt == 0:
        raise ValueError("t lies in the evaluation domain; resample")
    ni = shape.num_inputs
    nv = shape.num_variables
    gamma_inv = pow(gamma, -1, p)
    delta_inv = pow(delta, -1, p)

    hu, hv, hw = qap.evaluations_at_host(t)
    ncp = qap.num_cols_pad
    contrib = [(beta * x + alpha * y + z) % p for x, y, z in zip(hu, hv, hw)]
    pad = [0] * (ncp - nv)
    u_s = hu + pad
    v_s = hv + pad
    l_s = [0] * ni + [x * delta_inv % p for x in contrib[ni:]] + pad
    hpad = max(ncp, qap.m)
    h_s, cur = [], zt * delta_inv % p
    for _ in range(qap.m - 1):
        h_s.append(cur)
        cur = cur * t % p
    h_s += [0] * (hpad - len(h_s))
    gamma_abc_g1 = [curve.g1.mul(curve.g1_gen, x * gamma_inv % p)
                    for x in contrib[:ni]]
    mark("instance_map")

    dg1 = device_group(curve, "g1", device)
    dg2 = device_group(curve, "g2", device)
    t1 = dg1.fixed_base_table(curve.g1_gen)
    t2 = dg2.fixed_base_table(curve.g2_gen)
    mark("window_tables")
    enc = dg1.encode_scalars
    a_query = dg1.fixed_base_msm(t1, enc(u_s), pad_output=True)
    b_g1_query = dg1.fixed_base_msm(t1, enc(v_s), pad_output=True)
    h_query = dg1.fixed_base_msm(t1, enc(h_s), pad_output=True)
    l_query = dg1.fixed_base_msm(t1, enc(l_s), pad_output=True)
    mark("fixed_base_g1")
    b_g2_query = dg2.fixed_base_msm(t2, enc(v_s), pad_output=True)
    mark("fixed_base_g2")

    g1m, g2m = curve.g1.mul, curve.g2.mul
    vk = VerifyKey(
        alpha_g1=g1m(curve.g1_gen, alpha),
        beta_g2=g2m(curve.g2_gen, beta),
        gamma_g2=g2m(curve.g2_gen, gamma),
        delta_g2=g2m(curve.g2_gen, delta),
        gamma_abc_g1=gamma_abc_g1,
    )
    params = Parameters(
        curve=curve,
        vk=vk,
        beta_g1=g1m(curve.g1_gen, beta),
        delta_g1=g1m(curve.g1_gen, delta),
        domain_size=qap.m,
        a_query=a_query,
        b_g1_query=b_g1_query,
        b_g2_query=b_g2_query,
        h_query=h_query,
        l_query=l_query,
        num_inputs=ni,
        num_aux=shape.num_aux,
        num_constraints=shape.num_constraints,
        padded_queries=True,
    )
    mark("verifying_key")
    return params

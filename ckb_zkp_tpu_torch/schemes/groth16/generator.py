"""Groth16 trusted setup on torch.

Port of the reference's `generate_parameters_from_shape`
(`schemes/groth16/generator.py:47-185`). The default is the reference's
device branch (`:95-147`): the Lagrange coefficients at t on the device,
three transpose products for the instance map u_i(t), v_i(t), w_i(t), the
scalar algebra of `_setup_scalars` on the device, and five fixed-base MSMs
(K6 per window, `ops/msm.py`). Its output has the device-setup layout
(`padded_queries=True`): a, b_g1 and l queries padded to the aligned column
count (l is infinity at input slots), h padded to max(columns, m) with
infinity from m - 1 up, b_g2 pow2-padded. `host_mode=True` is the
reference's host branch (`:76-94`): the instance map in host ints and the
exact, unpadded layout. The verifying key is built in host ints. The
front ends `generate_random_parameters` and `generate_parameters` are the
reference's (`:25-45`) over the port's `r1cs.synthesize`, on `device`.
"""

from __future__ import annotations

import random

import torch

from ...host.pairing import PairingCurve
from ...ops.field import device_field
from ...ops.limbs import limbs_to_ints
from ...ops.msm import device_group
from ...r1cs import ConstraintSynthesizer, SynthesisMode, synthesize
from .prover import Stages
from .qap import QapMatrices, qap_matrices
from .types import Parameters, VerifyKey


def generate_random_parameters(circuit: ConstraintSynthesizer, curve: PairingCurve,
                               rng: random.Random, device="cuda") -> Parameters:
    r = curve.fr.modulus
    alpha, beta, gamma, delta = (rng.randrange(1, r) for _ in range(4))
    t = rng.randrange(1, r)
    return generate_parameters(circuit, curve, alpha, beta, gamma, delta, t, device)


def generate_parameters(circuit: ConstraintSynthesizer, curve: PairingCurve, alpha: int,
                        beta: int, gamma: int, delta: int, t: int,
                        device="cuda") -> Parameters:
    shape = synthesize(circuit, curve.fr.modulus, SynthesisMode.SETUP)
    return generate_parameters_from_shape(shape, curve, alpha, beta, gamma, delta, t,
                                          device=device)


def generate_parameters_from_shape(shape, curve, alpha: int, beta: int,
                                   gamma: int, delta: int, t: int,
                                   device="cuda", timings: dict | None = None,
                                   host_mode: bool = False):
    """Groth16 parameters for `shape` with toxic waste (alpha, beta, gamma,
    delta, t). `timings`, when given, receives per-stage seconds: lagrange,
    rmatvec, setup_scalars (instance_map with host_mode), window_tables,
    fixed_base_g1, fixed_base_g2, verifying_key."""
    mark = Stages(timings, device).mark
    p = curve.fr.modulus
    if host_mode:
        qap = QapMatrices(shape, curve.fr, device, host_mode=True)
    else:
        qap = qap_matrices(shape, curve.fr, device)
    zt = (pow(t, qap.m, p) - 1) % p
    if zt == 0:
        raise ValueError("t lies in the evaluation domain; resample")
    ni = shape.num_inputs
    gamma_inv = pow(gamma, -1, p)
    delta_inv = pow(delta, -1, p)
    dg1 = device_group(curve, "g1", device)
    dg2 = device_group(curve, "g2", device)

    if host_mode:
        hu, hv, hw = qap.evaluations_at_host(t)
        contrib = [(beta * x + alpha * y + z) % p for x, y, z in zip(hu, hv, hw)]
        ga_s = [x * gamma_inv % p for x in contrib[:ni]]
        h_s, cur = [], zt * delta_inv % p
        for _ in range(qap.m - 1):
            h_s.append(cur)
            cur = cur * t % p
        enc = dg1.encode_scalars
        u_can, v_can = enc(hu), enc(hv)
        l_can = enc([x * delta_inv % p for x in contrib[ni:]])
        h_can = enc(h_s)
        mark("instance_map")
    else:
        u, v, w = qap.evaluations_at(t, mark)
        u_can, v_can, ga_can, l_can, h_can = _setup_scalars(
            device_field(curve.fr, device), u, v, w, ni, qap.m,
            alpha, beta, gamma_inv, delta_inv, t, zt)
        ga_s = limbs_to_ints(ga_can)
        mark("setup_scalars")
    padded = not host_mode

    t1 = dg1.fixed_base_table(curve.g1_gen)
    t2 = dg2.fixed_base_table(curve.g2_gen)
    mark("window_tables")
    a_query = dg1.fixed_base_msm(t1, u_can, pad_output=padded)
    b_g1_query = dg1.fixed_base_msm(t1, v_can, pad_output=padded)
    h_query = dg1.fixed_base_msm(t1, h_can, pad_output=padded)
    l_query = dg1.fixed_base_msm(t1, l_can, pad_output=padded)
    mark("fixed_base_g1")
    b_g2_query = dg2.fixed_base_msm(t2, v_can, pad_output=padded)
    mark("fixed_base_g2")

    g1m, g2m = curve.g1.mul, curve.g2.mul
    vk = VerifyKey(
        alpha_g1=g1m(curve.g1_gen, alpha),
        beta_g2=g2m(curve.g2_gen, beta),
        gamma_g2=g2m(curve.g2_gen, gamma),
        delta_g2=g2m(curve.g2_gen, delta),
        gamma_abc_g1=[g1m(curve.g1_gen, s) for s in ga_s],
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
        padded_queries=padded,
    )
    mark("verifying_key")
    return params


def _setup_scalars(fr, u, v, w, ni: int, m: int, alpha: int, beta: int,
                   gamma_inv: int, delta_inv: int, t: int, zt: int):
    """The reference's `_setup_scalars` (`generator.py:113-142`) on the
    device: Montgomery u, v, w (num_cols_pad rows) -> canonical scalars of
    the a, b, gamma_abc, l and h queries. gamma_abc is the ni input rows,
    l the others (zero at the inputs); h = t^i zt / delta for i < m - 1, zero
    from m - 1 up to max(num_cols_pad, m)."""
    p = fr.spec.modulus
    ncp = u.shape[0]
    bu, av = fr.mul(torch.stack([u, v]), torch.stack(
        [fr.const(beta, (1,)), fr.const(alpha, (1,))])).unbind(0)
    contrib = fr.add(fr.add(bu, av), w)
    is_input = (torch.arange(ncp, device=u.device) < ni).unsqueeze(-1)
    scaled = fr.mul(contrib.unsqueeze(0), torch.stack(
        [fr.const(gamma_inv, (1,)), fr.const(delta_inv, (1,))]))
    ga_s = scaled[0][:ni]
    l_s = torch.where(is_input, torch.zeros_like(contrib), scaled[1])
    hpad = max(ncp, m)
    h_s = fr.mul(fr.powers(t, hpad), fr.const(zt * delta_inv % p, (1,)))
    h_s = torch.where((torch.arange(hpad, device=u.device) < m - 1).unsqueeze(-1),
                      h_s, torch.zeros_like(h_s))
    u_can, v_can, l_can = fr.from_mont(torch.stack([u, v, l_s])).unbind(0)
    return u_can, v_can, fr.from_mont(ga_s), l_can, fr.from_mont(h_s)

# Copied from ckb_zkp_tpu/schemes/groth16/serialize.py: the port keeps its own
# copy. It routes to the port's device groups, and `parameters_from_bytes`
# pads as the reference does on the CPU (`PAD_ABOVE`), so the port's
# prover gets the layout that `convert.params_from_reference` carries
# across from the reference's keys.
"""Groth16 key/proof (de)serialization, ark-0.2 wire format.

Field order matches the reference derives exactly
(ckb-zkp groth16/src/lib.rs:51-91): Proof{a,b,c};
VerifyKey{alpha_g1,beta_g2,gamma_g2,delta_g2,gamma_abc_g1};
Parameters{vk,beta_g1,delta_g1,a_query,b_g1_query,b_g2_query,h_query,l_query}.
"""

from __future__ import annotations

import io

from ...host.pairing import PairingCurve
from ...ops.msm import device_group
from ...serialize.ark import G1Codec, G2Codec, read_u64, write_u64
from .types import Parameters, Proof, VerifyKey

# keys with more columns are padded to the device layout on reading: the
# reference's `small_host_threshold` as it stands on the CPU (its default
# `CKB_ZKP_TPU_HOST_MSM_MAX`, `ops/msm.py:374-379`)
PAD_ABOVE = 512


def _codecs(curve: PairingCurve):
    return G1Codec(curve), G2Codec(curve)


def proof_to_bytes(curve: PairingCurve, proof: Proof) -> bytes:
    g1, g2 = _codecs(curve)
    return g1.to_bytes(proof.a) + g2.to_bytes(proof.b) + g1.to_bytes(proof.c)


def proof_from_bytes(curve: PairingCurve, data: bytes) -> Proof:
    g1, g2 = _codecs(curve)
    buf = io.BytesIO(data)
    return Proof(a=g1.read(buf), b=g2.read(buf), c=g1.read(buf))


def vk_to_bytes(curve: PairingCurve, vk: VerifyKey) -> bytes:
    g1, g2 = _codecs(curve)
    buf = io.BytesIO()
    buf.write(g1.to_bytes(vk.alpha_g1))
    buf.write(g2.to_bytes(vk.beta_g2))
    buf.write(g2.to_bytes(vk.gamma_g2))
    buf.write(g2.to_bytes(vk.delta_g2))
    write_u64(buf, len(vk.gamma_abc_g1))
    for p in vk.gamma_abc_g1:
        buf.write(g1.to_bytes(p))
    return buf.getvalue()


def vk_from_bytes(curve: PairingCurve, data: bytes) -> VerifyKey:
    g1, g2 = _codecs(curve)
    buf = io.BytesIO(data)
    alpha_g1 = g1.read(buf)
    beta_g2 = g2.read(buf)
    gamma_g2 = g2.read(buf)
    delta_g2 = g2.read(buf)
    n = read_u64(buf)
    gamma_abc = [g1.read(buf) for _ in range(n)]
    return VerifyKey(alpha_g1, beta_g2, gamma_g2, delta_g2, gamma_abc)


def parameters_to_bytes(params: Parameters) -> bytes:
    curve = params.curve
    g1c, g2c = _codecs(curve)
    device = params.a_query[0].device
    dg1 = device_group(curve, "g1", device)
    dg2 = device_group(curve, "g2", device)
    nv = params.num_inputs + params.num_aux
    ni = params.num_inputs
    m = params.domain_size
    if params.padded_queries:
        # in-memory arrays carry padding (types.Parameters docstring); the
        # wire format keeps the reference's exact logical lengths
        slices = [slice(nv), slice(nv), slice(nv), slice(m - 1),
                  slice(ni, ni + params.num_aux)]
    else:
        slices = [slice(None)] * 5
    buf = io.BytesIO()
    buf.write(vk_to_bytes(curve, params.vk))
    buf.write(g1c.to_bytes(params.beta_g1))
    buf.write(g1c.to_bytes(params.delta_g1))
    for (codec, dg, query), sl in zip(
        (
            (g1c, dg1, params.a_query),
            (g1c, dg1, params.b_g1_query),
            (g2c, dg2, params.b_g2_query),
            (g1c, dg1, params.h_query),
            (g1c, dg1, params.l_query),
        ),
        slices,
    ):
        pts = dg.decode_points(tuple(c[sl] for c in query))
        write_u64(buf, len(pts))
        for p in pts:
            buf.write(codec.to_bytes(p))
    return buf.getvalue()


def parameters_from_bytes(curve: PairingCurve, data: bytes, device="cuda") -> Parameters:
    g1c, g2c = _codecs(curve)
    dg1 = device_group(curve, "g1", device)
    dg2 = device_group(curve, "g2", device)
    buf = io.BytesIO(data)
    vk_alpha = g1c.read(buf)
    beta_g2 = g2c.read(buf)
    gamma_g2 = g2c.read(buf)
    delta_g2 = g2c.read(buf)
    n = read_u64(buf)
    gamma_abc = [g1c.read(buf) for _ in range(n)]
    vk = VerifyKey(vk_alpha, beta_g2, gamma_g2, delta_g2, gamma_abc)
    beta_g1 = g1c.read(buf)
    delta_g1 = g1c.read(buf)
    raw = []
    for codec in (g1c, g1c, g2c, g1c, g1c):
        k = read_u64(buf)
        raw.append([codec.read(buf) for _ in range(k)])
    a_pts, b1_pts, b2_pts, h_pts, l_pts = raw
    nv = len(a_pts)
    ni = len(gamma_abc)
    naux = len(l_pts)
    m = len(h_pts) + 1

    def pow2(x):
        return max(8, 1 << max(0, x - 1).bit_length())

    # big keys are re-padded to the device layout (the reference's pow2
    # rule, as `convert.params_from_reference` carries its keys across);
    # small keys stay exact
    padded = nv > PAD_ABOVE
    if padded:
        ncp = pow2(nv)
        inf1, inf2 = curve.g1.infinity, curve.g2.infinity
        a_pts = a_pts + [inf1] * (ncp - nv)
        b1_pts = b1_pts + [inf1] * (ncp - nv)
        b2_pts = b2_pts + [inf2] * (ncp - nv)
        h_pts = h_pts + [inf1] * (m - len(h_pts))
        l_pts = [inf1] * ni + l_pts + [inf1] * (ncp - ni - naux)
    return Parameters(
        curve=curve,
        vk=vk,
        beta_g1=beta_g1,
        delta_g1=delta_g1,
        domain_size=m,
        a_query=dg1.encode_points(a_pts),
        b_g1_query=dg1.encode_points(b1_pts),
        b_g2_query=dg2.encode_points(b2_pts),
        h_query=dg1.encode_points(h_pts),
        l_query=dg1.encode_points(l_pts),
        num_inputs=ni,
        num_aux=naux,
        num_constraints=0,
        padded_queries=padded,
    )

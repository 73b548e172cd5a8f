"""Carry a reference proving key or SRS across to the port.

`params_from_reference` turns the JAX package's Groth16 `Parameters`
(query arrays as numpy or jax arrays of uint32 16-bit limbs) into the
port's: the same layouts as int32 tensors on `device`, and host points
rebuilt as the port's own classes (`host/curves.py`). Both provers then
compute from the same key. `srs_from_reference` does the same for a KZG10
`UniversalParams` (Marlin's and PLONK's SRS), `asvc_params_from_reference`
for aSVC's `Parameters`. `spartan_nizk_params_from_reference`,
`spartan_snark_setup_from_reference`, `bulletproofs_generators_from_reference`,
`hyrax_params_from_reference` and `libra_params_from_reference` carry the
discrete-log schemes' parameters (Spartan's R1CS instance and SPARK
encoding too) across field by field (host ints and points, no device), so
that a port proof over them can be compared with the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .host.curves import AffinePoint
from .host.pairing import get_curve
from .host.ristretto import Curve25519, RistrettoPoint
from .ops.limbs import to_torch
from .schemes import asvc, kzg10
from .schemes.groth16.types import Parameters, VerifyKey

_QUERIES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")


def point_from_reference(pt) -> AffinePoint:
    return AffinePoint(pt.x, pt.y, pt.infinity)


def params_from_reference(params, device="cuda") -> Parameters:
    pt = point_from_reference
    vk = params.vk
    queries = {
        name: tuple(to_torch(np.asarray(c), device) for c in getattr(params, name))
        for name in _QUERIES
    }
    return Parameters(
        curve=get_curve(params.curve.name),
        vk=VerifyKey(
            alpha_g1=pt(vk.alpha_g1),
            beta_g2=pt(vk.beta_g2),
            gamma_g2=pt(vk.gamma_g2),
            delta_g2=pt(vk.delta_g2),
            gamma_abc_g1=[pt(g) for g in vk.gamma_abc_g1],
        ),
        beta_g1=pt(params.beta_g1),
        delta_g1=pt(params.delta_g1),
        domain_size=params.domain_size,
        num_inputs=params.num_inputs,
        num_aux=params.num_aux,
        num_constraints=params.num_constraints,
        padded_queries=params.padded_queries,
        **queries,
    )


def srs_from_reference(srs, device="cuda") -> kzg10.UniversalParams:
    """The JAX package's `kzg10.UniversalParams` as the port's: the power
    arrays as int32 limb tensors on `device`, the points as host points."""
    pt = point_from_reference
    powers = lambda q: tuple(to_torch(np.asarray(c), device) for c in q)  # noqa: E731
    return kzg10.UniversalParams(
        curve=get_curve(srs.curve.name),
        powers_of_g=powers(srs.powers_of_g),
        powers_of_gamma_g=powers(srs.powers_of_gamma_g),
        g=pt(srs.g),
        gamma_g=pt(srs.gamma_g),
        h=pt(srs.h),
        beta_h=pt(srs.beta_h),
    )


def asvc_params_from_reference(params, device="cuda") -> asvc.Parameters:
    """The JAX package's aSVC `Parameters` as the port's: the device point
    arrays (the G1 powers, the Lagrange commitments) as int32 limb tensors
    on `device`, the update keys, `a` and the G2 powers as host points."""
    pt = point_from_reference
    powers = lambda q: tuple(to_torch(np.asarray(c), device) for c in q)  # noqa: E731
    pk, vk = params.proving_key, params.verification_key
    powers_of_g1 = powers(pk.powers_of_g1)
    return asvc.Parameters(
        curve=get_curve(params.curve.name),
        proving_key=asvc.ProvingKey(
            powers_of_g1=powers_of_g1,
            l_of_g1=powers(pk.l_of_g1),
            update_keys=[asvc.UpdateKey(ai=pt(u.ai), ui=pt(u.ui)) for u in pk.update_keys],
        ),
        verification_key=asvc.VerificationKey(
            powers_of_g1=powers_of_g1,
            powers_of_g2=[pt(g) for g in vk.powers_of_g2],
            a=pt(vk.a),
        ),
        n=params.n,
        omega=params.omega,
    )


def _port_curve(curve):
    return Curve25519() if curve.name == "curve25519" else get_curve(curve.name)


def _port_value(v, modules):
    """A reference value of a discrete-log scheme -> the port's: each
    dataclass as the class of the same name in the first of the port's
    `modules` that has one, field by field; points as the port's point
    classes; curves as the port's registry entry; lists, tuples and ints
    as they are."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        name = type(v).__name__
        if name == "RistrettoPoint":
            return RistrettoPoint(v.X, v.Y, v.Z, v.T)
        if name in ("PairingCurve", "Curve25519"):
            return _port_curve(v)
        cls = next(getattr(m, name) for m in modules if hasattr(m, name))
        return cls(**{f.name: _port_value(getattr(v, f.name), modules)
                      for f in dataclasses.fields(v)})
    if type(v).__name__ == "AffinePoint":
        return point_from_reference(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_port_value(x, modules) for x in v)
    return v


def _spartan_value(v):
    from .schemes.spartan import common, nizk, snark

    return _port_value(v, (common, nizk, snark))


def spartan_nizk_params_from_reference(params, r1cs):
    """The reference's Spartan `NizkParameters` and `R1CSInstance` -> the
    port's (params, r1cs)."""
    return _spartan_value(params), _spartan_value(r1cs)


def spartan_snark_setup_from_reference(setup):
    """The reference's Spartan `SnarkSetup` (params, r1cs, encode,
    encode_commit) -> the port's."""
    return _spartan_value(setup)


def bulletproofs_generators_from_reference(gens):
    """The reference's Bulletproofs `Generators` -> the port's."""
    from .schemes.bulletproofs import arithmetic_circuit

    return _port_value(gens, (arithmetic_circuit,))


def hyrax_params_from_reference(params):
    """The reference's Hyrax `Parameters` -> the port's."""
    from .schemes.hyrax import params as hyrax_params
    from .schemes.spartan import common

    return _port_value(params, (hyrax_params, common))


def libra_params_from_reference(params):
    """The reference's Libra `Parameters` -> the port's (Libra's own class,
    Hyrax's parts)."""
    from .schemes.hyrax import params as hyrax_params
    from .schemes.libra import zk_linear_gkr
    from .schemes.spartan import common

    return _port_value(params, (zk_linear_gkr, hyrax_params, common))

"""Carry a reference proving key across to the port.

`params_from_reference` turns the JAX package's Groth16 `Parameters`
(query arrays as numpy or jax arrays of uint32 16-bit limbs) into the
port's: the same layouts as int32 tensors on `device`, and host points
rebuilt as the port's own classes (`host/curves.py`). Both provers then
compute from the same key.
"""

from __future__ import annotations

import numpy as np

from .host.curves import AffinePoint
from .host.pairing import get_curve
from .ops.limbs import to_torch
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

"""Groth16 prover on torch: the device branch of the reference prover.

Port of `create_proof_from_shape` (`schemes/groth16/prover.py:103-222`):
canonical witness limbs, the QAP witness map, five Pippenger MSMs (a,
b_g1, h, l in G1 and b in G2), and the final group algebra in host ints.
It accepts padded keys (device setup: the port's own, or the reference's)
and exact keys (the reference's host-mode setup). Every MSM runs the port's
Pippenger; there is no host-int shortcut for small circuits. The front
ends `create_random_proof`, `create_proof_no_zk` and `create_proof` are
the reference's (`:23-41`) over the port's `r1cs.synthesize`; every prove
runs on the device that holds the keys' queries.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from ...ops.limbs import ints_to_limbs
from ...ops.msm import device_group
from ...r1cs import ConstraintSynthesizer, SynthesisMode, synthesize
from .qap import qap_matrices
from .types import Parameters, Proof


def create_random_proof(params: Parameters, circuit: ConstraintSynthesizer,
                        rng: random.Random) -> Proof:
    r_mod = params.curve.fr.modulus
    r = rng.randrange(r_mod)
    s = rng.randrange(r_mod)
    return create_proof(params, circuit, r, s)


def create_proof_no_zk(params: Parameters, circuit: ConstraintSynthesizer) -> Proof:
    return create_proof(params, circuit, 0, 0)


def create_proof(params: Parameters, circuit: ConstraintSynthesizer, r: int,
                 s: int) -> Proof:
    shape = synthesize(circuit, params.curve.fr.modulus, SynthesisMode.PROVE)
    return create_proof_from_shape(params, shape, r, s)


class Stages:
    """Per-stage wall-clock seconds, synchronizing the card at each mark."""

    def __init__(self, out: dict | None, device):
        self.out = out
        self.cuda = torch.device(device).type == "cuda"
        self.t = time.perf_counter()

    def mark(self, name: str):
        if self.out is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.out[name] = now - self.t
        self.t = now

    def add(self, name: str):
        """`mark`, adding to the seconds `name` already holds (a stage
        that runs once a layer)."""
        if self.out is None:
            return
        before = self.out.get(name, 0.0)
        self.mark(name)
        self.out[name] += before


def _fit_h(h_can, rows: int):
    """The h scalars cut to `rows`, the keys' h_query width. Padded keys
    from the reference's `parameters_from_bytes` hold m rows of h_query,
    not num_cols_pad; the witness map's rows from m - 1 on are zero, so
    the cut drops nothing, and a nonzero row cut raises ValueError."""
    if h_can.shape[0] <= rows:
        return h_can
    if bool(h_can[rows:].any()):
        raise ValueError(f"h: a nonzero scalar past the keys' {rows} h_query rows")
    return h_can[:rows]


def create_proof_from_shape(params, shape, r: int, s: int,
                            timings: dict | None = None):
    """Proof for `shape`'s assignment under `params`, with randomness r, s.

    `timings`, when given, receives per-stage seconds (qap: the shape's
    kept device matrices, built on its first prove; witness_limbs,
    witness_map, msm_a, msm_b_g2, msm_b_g1, msm_h, msm_l, decode,
    final_algebra)."""
    curve = params.curve
    p = curve.fr.modulus
    device = params.a_query[0].device
    st = Stages(timings, device)
    qap = qap_matrices(shape, curve.fr, device)
    qap.device_parts()
    assert qap.m == params.domain_size, "circuit does not match parameters"
    st.mark("qap")
    dg1 = device_group(curve, "g1", device)
    dg2 = device_group(curve, "g2", device)
    ni = shape.num_inputs
    padded = params.padded_queries
    L = dg1.fr.L

    z = shape.full_assignment()
    ncols = qap.num_cols_pad if padded else len(z)
    raw = ints_to_limbs([v % p for v in z] + [0] * (ncols - len(z)), L)
    z_can = torch.as_tensor(raw.astype(np.int32), device=device)
    st.mark("witness_limbs")

    hpad = max(qap.num_cols_pad, qap.m) if padded else qap.m
    h_can = qap.witness_map(z_can, out_len=hpad)
    h_can = _fit_h(h_can, params.h_query[0].shape[0] if padded else qap.m - 1)
    st.mark("witness_map")

    ga_acc = dg1.msm(params.a_query, z_can)
    st.mark("msm_a")
    gb2_acc = dg2.msm(params.b_g2_query, z_can)
    st.mark("msm_b_g2")
    gb1_acc = None
    if r != 0:
        # with r == 0, C has no r*B1 term and the reference skips the G1
        # b-query MSM (prover.rs:170-179)
        gb1_acc = dg1.msm(params.b_g1_query, z_can)
        st.mark("msm_b_g1")
    h_acc = dg1.msm(params.h_query, h_can)
    st.mark("msm_h")
    # padded l_query holds infinity at input slots, so the full z pairs
    # correctly; exact keys pair the aux scalars only
    l_acc = dg1.msm(params.l_query, z_can if padded else z_can[ni:])
    st.mark("msm_l")

    ga = dg1.decode_point(ga_acc)
    gb2 = dg2.decode_point(gb2_acc)
    gb1 = dg1.decode_point(gb1_acc) if gb1_acc is not None else None
    h_pt = dg1.decode_point(h_acc)
    l_pt = dg1.decode_point(l_acc)
    st.mark("decode")

    g1, g2 = curve.g1, curve.g2
    # A = alpha + sum z_i u_i(t) + r delta
    a_pt = g1.add(g1.add(params.vk.alpha_g1, ga), g1.mul(params.delta_g1, r))
    # B = beta + sum z_i v_i(t) + s delta (G2), B1 the same in G1
    b_pt = g2.add(g2.add(params.vk.beta_g2, gb2), g2.mul(params.vk.delta_g2, s))
    # C = l + h + s A + r B1 - r s delta
    c_pt = g1.add(l_pt, h_pt)
    c_pt = g1.add(c_pt, g1.mul(a_pt, s))
    if r != 0:
        b1_pt = g1.add(g1.add(params.beta_g1, gb1), g1.mul(params.delta_g1, s))
        c_pt = g1.add(c_pt, g1.mul(b1_pt, r))
        c_pt = g1.sub(c_pt, g1.mul(params.delta_g1, r * s % p))
    st.mark("final_algebra")
    return Proof(a=a_pt, b=b_pt, c=c_pt)

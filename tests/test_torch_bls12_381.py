"""Groth16 over BLS12-381 in the port on the CPU (Fq at L = 24 limbs, the
12-word kernels' plain versions; Fr at L = 16), held against the JAX
package and the host ints: the G1 and G2 Pippenger MSMs against
`host.msm`; the plain versions of K5 and K6's elementwise step (edge
cases, G1 and G2), K2 (through a sort order), K3/K4 and K6's fixed-base
MSM (G1) against the JAX package's `ops/rcb.py` and its CPU scan
fallbacks; and the m = 16 square chain: the port's device setup
query for query against the JAX package's host-mode setup, the proof for
(r, s) = (5, 6) with the port's keys and the proof for (0, 0) with the
JAX package's keys carried across (`params_from_reference`), each equal to
the JAX proof, both verifiers' verdicts. No jitted JAX MSM runs (eager
RCB ops and host-mode setups only). Tolerance: none."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckb_zkp_tpu.bench_circuits import square_chain_shape as ref_square_chain
from ckb_zkp_tpu.host.pairing import get_curve as ref_curve
from ckb_zkp_tpu.ops import msm as ref_msm
from ckb_zkp_tpu.ops.msm import device_group as ref_device_group
from ckb_zkp_tpu.ops.rcb import rcb_group as ref_rcb_group
from ckb_zkp_tpu.schemes import groth16 as ref_groth16
from ckb_zkp_tpu.schemes.groth16.qap import QapMatrices as RefQap
from ckb_zkp_tpu_torch.bench_circuits import square_chain_shape
from ckb_zkp_tpu_torch.convert import params_from_reference
from ckb_zkp_tpu_torch.host.pairing import get_curve
from ckb_zkp_tpu_torch.ops import cuda_rcb
from ckb_zkp_tpu_torch.ops.limbs import to_numpy, to_torch
from ckb_zkp_tpu_torch.ops.msm import device_group
from ckb_zkp_tpu_torch.schemes import groth16

torch.set_num_threads(1)
RCURVE = ref_curve("bls12_381")
CURVE = get_curve("bls12_381")
FR = CURVE.fr.modulus
TOXIC = (11, 12, 13, 14, 15)  # alpha, beta, gamma, delta, t
QUERIES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")


def _pt(p):
    return (True, None, None) if p.infinity else (False, p.x, p.y)


def _proof(p):
    return [_pt(p.a), _pt(p.b), _pt(p.c)]


def _t(pt):
    return tuple(to_torch(np.asarray(c), "cpu") for c in pt)


def _same(ref_pt, port_pt):
    return all(np.array_equal(np.asarray(jax.device_get(a)), to_numpy(b))
               for a, b in zip(ref_pt, port_pt))


def _groups(group):
    rdg = ref_device_group(RCURVE, group)
    return rdg, ref_rcb_group(rdg), device_group(CURVE, group, "cpu")


def _points(group, n, seed):
    host = CURVE.g1 if group == "g1" else CURVE.g2
    gen = CURVE.g1_gen if group == "g1" else CURVE.g2_gen
    ks = np.random.default_rng(seed).integers(2, 1 << 62, size=n)
    return [host.mul(gen, int(k)) for k in ks]


def test_field_widths():
    """Fq at 24 limbs (the 12-word kernels), Fr at 16 (the 8-word ones),
    and the constant blocks the kernels read."""
    dg = device_group(CURVE, "g2", "cpu")
    assert (dg.fq.L, dg.fr.L) == (24, 16)
    assert int(dg.fq.kconsts[0]) == 12 and int(dg.fr.kconsts[0]) == 8
    rg1 = device_group(CURVE, "g1", "cpu").rg
    assert int(rg1.kconsts[2]) == 12  # G1's 3b = 12: the add chain
    # G2's 3b = 12 + 12u: the add chain too, over both components (b3_twist)
    assert (int(dg.rg.kconsts[2]), int(dg.rg.kconsts[-1])) == (12, 1)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_matches_host_msm(group):
    """36 points with an infinity and a zero scalar, against `host.msm`."""
    dg = device_group(CURVE, group, "cpu")
    pts = _points(group, 36, 5)
    pts[3] = dg.host_group.infinity
    rng = np.random.default_rng(6)
    sc = [int.from_bytes(rng.bytes(32), "little") % FR for _ in pts]
    sc[7] = 0
    got = dg.decode_point(dg.msm(dg.encode_points(pts), dg.encode_scalars(sc)))
    assert _pt(got) == _pt(dg.host_group.msm(pts, sc))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_add_and_madd_plain_match_reference_edge_cases(group):
    """K5's plain version (Alg. 7) and the mixed add of K6's step (Alg. 8)
    against the JAX package's RcbGroup, bit for bit: general projective
    Z, P = Q, P = -Q, identities and flagged leaves; and the host group."""
    rdg, rrg, dg = _groups(group)
    rg, host = dg.rg, dg.host_group
    pts = _points(group, 3, 11)
    a, inf = pts[0], host.infinity
    left = pts + [a, a, inf, a, inf]
    right = pts[::-1] + [host.neg(a), a, a, inf, inf]
    P = rrg.from_affine_enc(rdg.encode_points(left))
    Q = rrg.from_affine_enc(rdg.encode_points(right))
    P = rrg.add(P, Q)  # general projective Z
    assert _same(rrg.add(P, Q), rg.add(_t(P), _t(Q)))
    Xq, Yq, Zq = rdg.encode_points(right)
    rinf = rdg.cf.is_zero(Zq)
    leaves = (to_torch(Xq, "cpu"), to_torch(Yq, "cpu"), torch.as_tensor(np.array(rinf)))
    assert _same(rrg.madd(P, (Xq, Yq, rinf)), rg.madd(_t(P), leaves))
    Pa = _t(rrg.from_affine_enc(rdg.encode_points(left)))
    got = dg.decode_points_host(rg.to_jacobian(rg.add(Pa, rg.from_affine_enc(
        dg.encode_points(right)))))
    assert [_pt(p) for p in got] == [_pt(host.add(x, y)) for x, y in zip(left, right)]


def test_scan_prefix_madd_plain_matches_reference():
    """Plain K2 (G1) reading its leaves through the sort order of 3 rows of
    digits (1/8 flagged) against the JAX package's `_scan_prefix_madd` on
    the leaves gathered in that order: the flag sits in bit 31 of the top
    word of the 12-word packed X."""
    group, n, B = "g1", 45, 5
    rdg, rrg, dg = _groups(group)
    k = 3
    pts = _points(group, 6, 21)
    rng = np.random.default_rng(n)
    sel = [pts[i] for i in rng.integers(0, 6, size=n // k)]
    for i in rng.integers(0, n // k, size=max(1, n // 24)):
        sel[i] = dg.host_group.infinity
    X0, Y0, Z0 = rdg.encode_points(sel)
    inf0 = np.asarray(Z0).reshape(n // k, -1).max(axis=1) == 0
    order = np.argsort(rng.integers(0, 8, size=(k, n // k)), axis=1, kind="stable").reshape(-1)
    X, Y, inf = jnp.asarray(X0)[order], jnp.asarray(Y0)[order], inf0[order]
    w_get, T = ref_msm._scan_prefix_madd(rrg, (X, Y, jnp.asarray(inf)), B)
    Wref = w_get(jnp.arange(n))
    xw, yw = cuda_rcb.pack_limbs_flag(dg.rg, to_torch(X0, "cpu"), to_torch(Y0, "cpu"),
                                     torch.as_tensor(inf0))
    assert xw.shape[1] == 12 * dg.cf.ext
    assert torch.equal(xw[:, -1] < 0, torch.as_tensor(inf0))
    W, Tp = cuda_rcb.scan_prefix_madd(dg.rg, xw, yw, B, order=torch.as_tensor(order))
    assert _same(Wref, W) and _same(T, Tp)


def test_scan_add_and_totals_plain_match_reference_full_prefix():
    """Plain K3 and K4 (G1) rebuild the JAX package's `_full_prefix` bit
    for bit, with a B = n tail."""
    rdg, rrg, dg = _groups("g1")
    rg = dg.rg
    B, n = 8, 24
    pts = rrg.add(rrg.from_affine_enc(rdg.encode_points(_points("g1", n, 31))),
                  rrg.from_affine_enc(rdg.encode_points(_points("g1", n, 32))))  # general Z
    want = ref_msm._full_prefix(rrg, pts, B)
    tp = _t(pts)
    W, T = cuda_rcb.scan_prefix_add(rg, tp, B)
    assert all(torch.equal(a, b) for a, b in zip(T, cuda_rcb.scan_total_add(rg, tp, B)))
    P2, _ = cuda_rcb.scan_prefix_add(rg, T, T[0].shape[0])
    ident = rg.identity((1,))
    Pex = tuple(torch.cat([i, c[:-1]]) for i, c in zip(ident, P2))
    rep = tuple(torch.repeat_interleave(c, B, dim=0)[:n] for c in Pex)
    assert _same(want, rg.add(rep, W))


def test_fixed_base_plain_matches_reference_projective():
    """K6's fixed-base MSM (plain, G1) against the JAX package's
    `_fixed_base_rcb` on the same window table, limb for limb, with the
    zero scalar, r - 1 and a run of zero digits."""
    rdg = ref_device_group(RCURVE, "g1")
    dg = device_group(CURVE, "g1", "cpu")
    table = dg.fixed_base_table(dg.curve.g1_gen)
    rtable = rdg.fixed_base_table(RCURVE.g1_gen)
    assert all(np.array_equal(to_numpy(t), np.asarray(jax.device_get(r)))
               for t, r in zip(table, rtable))
    rng = np.random.default_rng(8)
    sc = [int.from_bytes(rng.bytes(32), "little") % FR for _ in range(9)]
    sc[:3] = [0, FR - 1, sc[3] & ~(((1 << 128) - 1) << 64)]
    s = dg.encode_scalars(sc)
    got = cuda_rcb.rcb_fixed_base(dg.rg, table[0], table[1], s)
    want = rdg._fixed_base_rcb(rtable, jnp.asarray(to_numpy(s)))
    assert _same(want, got)


@pytest.fixture(scope="module")
def chain():
    """The m = 16 square chain: the JAX package's host-mode keys and the
    port's device-branch keys for the same toxic waste."""
    rshape = ref_square_chain(14, FR)
    shape = square_chain_shape(14, FR)
    ref = ref_groth16.generate_parameters_from_shape(rshape, RCURVE, *TOXIC, host_mode=True)
    port = groth16.generate_parameters_from_shape(shape, CURVE, *TOXIC, device="cpu")
    return rshape, shape, ref, port


def test_device_setup_equals_the_reference_host_mode_setup(chain):
    rshape, shape, ref, port = chain
    assert port.domain_size == ref.domain_size == 16 and port.padded_queries
    ni = shape.num_inputs
    for name in QUERIES:
        d = getattr(port, name)
        h = tuple(to_torch(np.asarray(c), "cpu") for c in getattr(ref, name))
        off = ni if name == "l_query" else 0
        n = h[0].shape[0]
        assert all(torch.equal(dc[off: off + n], hc) for dc, hc in zip(d, h)), name
        pad = torch.cat([d[2][:off], d[2][off + n:]])
        assert not bool(pad.any()), name
    assert params_from_reference(ref, "cpu").vk == port.vk


@pytest.mark.parametrize("keys,r,s", [("port", 5, 6), ("reference", 0, 0)])
def test_proofs_equal_the_reference_and_verify(chain, keys, r, s):
    """The port's proof for (r, s), with its own keys or the JAX package's
    carried across, equals the JAX proof; both verifiers accept it and
    refuse a wrong public input."""
    rshape, shape, ref, port = chain
    params = port if keys == "port" else params_from_reference(ref, "cpu")
    proof = groth16.create_proof_from_shape(params, shape, r, s)
    want = ref_groth16.create_proof_from_shape(
        ref, rshape, r, s, qap=RefQap(rshape, RCURVE.fr, host_mode=True))
    assert _proof(proof) == _proof(want)
    publics = shape.input_assignment[1:]
    wrong = [(publics[0] + 1) % FR]
    pvk = groth16.prepare_verifying_key(CURVE, params.vk)
    assert groth16.verify_proof(CURVE, pvk, proof, publics)
    assert not groth16.verify_proof(CURVE, pvk, proof, wrong)
    rpvk = ref_groth16.prepare_verifying_key(RCURVE, ref.vk)
    assert ref_groth16.verify_proof(RCURVE, rpvk, want, publics)
    assert not ref_groth16.verify_proof(RCURVE, rpvk, want, wrong)

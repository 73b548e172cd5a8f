"""The port's RCB group ops (K5's plain version) and the blocked scans (the
plain versions of K2, also through a sort order, K3 and K4) against the
reference's RcbGroup and its CPU scan fallbacks. Projective coordinates are
compared bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckb_zkp_tpu.host.pairing import get_curve
from ckb_zkp_tpu.ops import msm as ref_msm
from ckb_zkp_tpu.ops.msm import device_group as ref_device_group
from ckb_zkp_tpu.ops.rcb import rcb_group as ref_rcb_group
from ckb_zkp_tpu_torch.ops import cuda_rcb
from ckb_zkp_tpu_torch.ops.limbs import to_numpy, to_torch
from ckb_zkp_tpu_torch.ops.msm import device_group

torch.set_num_threads(1)
CURVE = get_curve("bn254")


def _points(group, n, seed):
    """n affine host points k*G with k from a numpy seed."""
    host = CURVE.g1 if group == "g1" else CURVE.g2
    gen = CURVE.g1_gen if group == "g1" else CURVE.g2_gen
    ks = np.random.default_rng(seed).integers(2, 1 << 62, size=n)
    return [host.mul(gen, int(k)) for k in ks]


def _t(pt):
    return tuple(to_torch(np.asarray(c), "cpu") for c in pt)


def _same(ref_pt, port_pt):
    return all(
        np.array_equal(np.asarray(jax.device_get(a)), to_numpy(b))
        for a, b in zip(ref_pt, port_pt)
    )


def _affine(pts):
    return [(True, None, None) if p.infinity else (False, p.x, p.y) for p in pts]


def _groups(group):
    rdg = ref_device_group(CURVE, group)
    return rdg, ref_rcb_group(rdg), device_group(CURVE, group, "cpu")


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_add_madd_double_bit_exact(group):
    rdg, rrg, dg = _groups(group)
    rg, host = dg.rg, rdg.host_group
    pts = _points(group, 6, 11)
    a, inf = pts[0], host.infinity
    left = pts + [a, a, inf, a, inf]
    right = pts[::-1] + [host.neg(a), inf, a, a, inf]
    P = rrg.from_affine_enc(rdg.encode_points(left))
    Q = rrg.from_affine_enc(rdg.encode_points(right))
    P = rrg.add(P, Q)  # general (non-affine) projective Z
    tP, tQ = _t(P), _t(Q)
    assert _same(rrg.add(P, Q), rg.add(tP, tQ))
    assert _same(rrg.add(P, P), rg.add(tP, tP))
    assert _same(rrg.double(P), rg.double(tP))
    assert _same(rrg.to_jacobian(P), rg.to_jacobian(tP))
    rinf = rdg.cf.is_zero(Q[2])
    tinf = dg.cf.is_zero(tQ[2])
    assert _same(rrg.madd(P, (Q[0], Q[1], rinf)), rg.madd(tP, (tQ[0], tQ[1], tinf)))
    # the complete formulas agree with the host group at the edge cases
    Pa = _t(rrg.from_affine_enc(rdg.encode_points(left)))
    Qa = _t(rrg.from_affine_enc(rdg.encode_points(right)))
    got = dg.decode_points_host(rg.to_jacobian(rg.add(Pa, Qa)))
    assert _affine(got) == _affine(host.add(x, y) for x, y in zip(left, right))
    assert _same(rrg.neg(P), rg.neg(tP))


def _leaves(rdg, group, n, seed):
    pts = _points(group, 8, seed)
    rng = np.random.default_rng(seed)
    sel = [pts[i] for i in rng.integers(0, 8, size=n)]
    for i in rng.integers(0, n, size=max(1, n // 8)):
        sel[i] = rdg.host_group.infinity
    X, Y, Z = rdg.encode_points(sel)
    return X, Y, np.asarray(Z).reshape(n, -1).max(axis=1) == 0


@pytest.mark.parametrize("group,n,B", [("g1", 96, 32), ("g2", 96, 32), ("g1", 15, 5)])
def test_scan_prefix_madd_matches_reference_fallback(group, n, B):
    """Plain K2 against the reference's `_scan_prefix_madd` on n leaves (3
    chains, 1/8 of the leaves flagged) that are n // 3 leaves gathered
    through the sort order of 3 rows of random digits, as a window batch
    sorts them: once on the gathered leaves, once reading the n // 3
    leaves through the order."""
    rdg, rrg, dg = _groups(group)
    k = 3
    X0, Y0, inf0 = _leaves(rdg, group, n // k, 21 + n)
    assert 0 < inf0.sum() < n // k
    digits = np.random.default_rng(n).integers(0, 8, size=(k, n // k))
    order = np.argsort(digits, axis=1, kind="stable").reshape(-1)
    X, Y, inf = jnp.asarray(X0)[order], jnp.asarray(Y0)[order], inf0[order]
    w_get, T = ref_msm._scan_prefix_madd(rrg, (X, Y, jnp.asarray(inf)), B)
    Wref = w_get(jnp.arange(n))
    xw, yw = cuda_rcb.pack_limbs_flag(dg.rg, to_torch(X, "cpu"), to_torch(Y, "cpu"),
                                     torch.as_tensor(inf))
    W, Tp = cuda_rcb.scan_prefix_madd(dg.rg, xw, yw, B)
    assert _same(Wref, W) and _same(T, Tp)
    assert torch.equal(cuda_rcb.unpack_leaves(dg.rg, xw, yw)[2], torch.as_tensor(inf))
    xw0, yw0 = cuda_rcb.pack_limbs_flag(dg.rg, to_torch(X0, "cpu"), to_torch(Y0, "cpu"),
                                       torch.as_tensor(inf0))
    W, Tp = cuda_rcb.scan_prefix_madd(dg.rg, xw0, yw0, B, order=torch.as_tensor(order))
    assert _same(Wref, W) and _same(T, Tp)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_windows_through_order_equal_gathering_first(group):
    """`_windows` (K2 through the sort order) against the same window sums
    from the leaves gathered first, bit for bit, and against the host
    group's sum_i d_i P_i of each row (2 rows of 32 points, 2-bit digits)."""
    rdg, _, dg = _groups(group)
    rg, host = dg.rg, dg.host_group
    k, npad, c = 2, 32, 2
    pts = _points(group, npad, 61)
    pts[3] = host.infinity
    X, Y, Z = dg.encode_points(pts)
    xw, yw = cuda_rcb.pack_limbs_flag(rg, X, Y, dg.cf.is_zero(Z))
    digits = torch.as_tensor(np.random.default_rng(62).integers(0, 1 << c, (k, npad)))
    got = dg._windows(xw, yw, digits, c)
    order = torch.sort(digits, dim=1).indices
    W, T = cuda_rcb.scan_prefix_madd(rg, xw[order].reshape(k * npad, -1),
                                     yw[order].reshape(k * npad, -1), 32)
    want = dg._weigh_buckets(dg._bucket_prefixes(W, T, digits, c), c)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for row, p in zip(digits.tolist(), dg.decode_points_host(rg.to_jacobian(got))):
        h = host.infinity
        for d, q in zip(row, pts):
            h = host.add(h, host.mul(q, d))
        assert (p.infinity, p.x, p.y) == (h.infinity, h.x, h.y)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scan_add_and_totals_match_reference_full_prefix(group):
    """K3 and K4 (plain) rebuild the reference's CPU _full_prefix bit for bit."""
    rdg, rrg, dg = _groups(group)
    rg = dg.rg
    B, n = 32, 96
    X, Y, inf = _leaves(rdg, group, n, 31)
    Z = np.where(inf.reshape((n,) + (1,) * (np.asarray(X).ndim - 1)), 0,
                 np.asarray(rdg.cf.ones((n,))))
    pts = rrg.add(rrg.from_affine_enc((X, Y, Z)), rrg.from_affine_enc((Y, X, Z)))
    want = ref_msm._full_prefix(rrg, pts, B)
    tp = _t(pts)
    W, T = cuda_rcb.scan_prefix_add(rg, tp, B)
    assert _same(T, cuda_rcb.scan_total_add(rg, tp, B))
    G = T[0].shape[0]
    P2, Ttop = cuda_rcb.scan_prefix_add(rg, T, G)  # one block: a sequential scan
    ident = rg.identity((1,))
    Pex = tuple(torch.cat([i, c[:-1]]) for i, c in zip(ident, P2))
    rep = tuple(torch.repeat_interleave(c, B, dim=0)[:n] for c in Pex)
    assert _same(want, rg.add(rep, W))
    # tail launch, B = n = 5 in one block: the same sequence of adds as the
    # first block's within-block prefix at 4 (W, held to the reference above)
    tail = cuda_rcb.scan_total_add(rg, tuple(c[:5] for c in tp), 5)
    assert all(torch.equal(a, b[4:5]) for a, b in zip(tail, W))
    assert _same(tuple(c[-1:] for c in P2), Ttop)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_madd_k6_plain_matches_reference_edge_cases(group):
    """K6's plain version (the port's RcbGroup.madd on CPU tensors) against
    the reference's RcbGroup.madd, bit for bit: general projective
    accumulators, P = Q, P = -Q, identity accumulators and flagged leaves;
    and against the host group."""
    rdg, rrg, dg = _groups(group)
    rg, host = dg.rg, rdg.host_group
    pts = _points(group, 6, 41)
    a, b, inf = pts[0], pts[1], host.infinity
    left = pts + [a, b, inf, a, inf]
    right = pts[::-1] + [a, host.neg(b), a, inf, inf]
    Pa = rrg.from_affine_enc(rdg.encode_points(left))
    Xq, Yq, Zq = rdg.encode_points(right)
    rinf = rdg.cf.is_zero(Zq)
    leaves = (to_torch(Xq, "cpu"), to_torch(Yq, "cpu"),
              torch.as_tensor(np.array(rinf)))
    for P in (Pa, rrg.add(Pa, Pa)):  # Z = 1 (or 0), and a general Z
        want = rrg.madd(P, (Xq, Yq, rinf))
        got = cuda_rcb.rcb_madd(rg, _t(P), leaves)
        assert _same(want, got)
        assert _same(want, rg.madd(_t(P), leaves))
        assert _same(want, cuda_rcb.rcb_madd_plain(rg, _t(P), leaves))
    got = dg.decode_points_host(rg.to_jacobian(rg.madd(_t(Pa), leaves)))
    assert _affine(got) == _affine(host.add(x, y) for x, y in zip(left, right))
    # one leaf broadcast against the batch, as rcb_madd_pallas broadcasts
    one = tuple(c[3:4] for c in leaves)
    full = tuple(c[3:4].expand(c.shape) for c in leaves)
    assert all(torch.equal(x, y) for x, y in
               zip(rg.madd(_t(Pa), one), rg.madd(_t(Pa), full)))


def test_madd_k6_wrapper_refuses_non_cpu_tensors_without_a_kernel():
    """The wrapper takes the plain version only for CPU tensors: any other
    tensor goes to the kernel, whose operand checks refuse a non-CUDA one
    (after broadcasting the flags against the points)."""
    dg = device_group(CURVE, "g2", "cpu")
    pt = tuple(torch.empty((4, 2, 16), dtype=torch.int32, device="meta")
               for _ in range(3))
    flags = torch.zeros((1,), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rcb.rcb_madd(dg.rg, pt, (pt[0][:1], pt[1], flags))


def test_b3_add_chain_constants_and_the_twist_identity():
    """The kernels' constant block (`kernel_consts`, read by
    `csrc/rcb.cuh` `parse_consts`) has them multiply by 3b with an add
    chain on BN254's G1 (3b = 9) and on BLS12-381's G1 (12) and G2 (12 + 12
    u, b3_twist), and by the Montgomery constant on BN254's G2 (3b = 9 /
    (9 + u)); over BLS12-381 Fq, k (x0 - x1) + k (x0 + x1) u (field.cuh
    `fp2_twist_b3`) equals (x0 + x1 u) 3b' for seeded x, in host ints."""
    from ckb_zkp_tpu_torch.host.pairing import get_curve as port_curve
    from ckb_zkp_tpu_torch.ops.cuda_field import MAXW

    want = {("bn254", "g1"): (9, 0), ("bn254", "g2"): (0, 0),
            ("bls12_381", "g1"): (12, 0), ("bls12_381", "g2"): (12, 1)}
    for (name, group), (k, twist) in want.items():
        kc = device_group(port_curve(name), group, "cpu").rg.kconsts
        assert (int(kc[2]), int(kc[3 + 4 * MAXW])) == (k, twist), (name, group)
    curve = port_curve("bls12_381")
    p = curve.fq.modulus
    b3 = tuple(3 * b % p for b in curve.g2.b)
    assert b3 == (12, 12)
    rng = np.random.default_rng(19)
    for _ in range(64):
        x0, x1 = (int.from_bytes(rng.bytes(48), "little") % p for _ in range(2))
        chain = (12 * (x0 - x1) % p, 12 * (x0 + x1) % p)
        assert chain == tuple(curve.tower.f2_mul((x0, x1), b3))
    assert tuple(curve.tower.f2_mul((1, p - 1), b3)) == (24, 0)

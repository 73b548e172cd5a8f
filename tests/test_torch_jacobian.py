"""The port's Jacobian MSM engine on the CPU: the plain versions of K8,
K9a, K9b and K9c and `ec_double`/`to_affine` against the JAX package's
eager `ops/ec.py`, bit for bit; the bucket-boundary prefixes (with the
tiling thresholds patched small, so that a K9b and a K9c level run) and
the engine's MSM against host ints and the port's RCB engine. JAX runs
eagerly here: no jitted JAX MSM. Tolerance: none."""

import copy

import jax
import numpy as np
import pytest
import torch

from ckb_zkp_tpu.host.pairing import get_curve
from ckb_zkp_tpu.ops import ec as ref_ec
from ckb_zkp_tpu.ops.msm import device_group as ref_device_group
from ckb_zkp_tpu_torch.host.curves import WeierstrassGroup
from ckb_zkp_tpu_torch.host.pairing import get_curve as port_curve
from ckb_zkp_tpu_torch.ops import cuda_ec, ec, msm
from ckb_zkp_tpu_torch.ops.limbs import to_numpy, to_torch
from ckb_zkp_tpu_torch.ops.msm import DeviceCurveGroup, device_group

torch.set_num_threads(1)
CURVE = get_curve("bn254")


def _host(group):
    return (CURVE.g1, CURVE.g1_gen) if group == "g1" else (CURVE.g2, CURVE.g2_gen)


def _points(group, n, seed):
    host, gen = _host(group)
    ks = np.random.default_rng(seed).integers(2, 1 << 62, size=n)
    return [host.mul(gen, int(k)) for k in ks]


def _t(pt):
    return tuple(to_torch(np.asarray(c), "cpu") for c in pt)


def _same(ref_pt, port_pt):
    return all(np.array_equal(np.asarray(jax.device_get(a)), to_numpy(b))
               for a, b in zip(ref_pt, port_pt))


def _affine(pts):
    return [(True, None, None) if p.infinity else (False, p.x, p.y) for p in pts]


def _decode(dg, P):
    """(k, Q) Jacobian points -> host points, row after row."""
    return dg.decode_points_host(tuple(c.reshape(-1, *dg.cf.coord_shape) for c in P))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_add_madd_double_affine_match_jax(group):
    """K8 and K9a (plain) against the JAX package's eager `ec_add`, with
    general-Z Jacobian accumulators and the five edge cases of the
    reference's tests (P = Q, P = -Q, identity on each side, both); K9a's
    q is the affine form of ec_add's, Z in {0, one}. Then `ec_double`,
    `ec_neg`, `to_affine` and the host group."""
    rdg, dg = ref_device_group(CURVE, group), device_group(CURVE, group, "cpu")
    rcf, cf, host = rdg.cf, dg.cf, dg.host_group
    a, b, c = _points(group, 3, 7)
    inf = host.infinity
    left = [a, a, a, inf, inf, b, c, b]
    right = [a, host.neg(a), inf, a, inf, c, a, a]
    Qa = rdg.encode_points(right)
    P = ref_ec.ec_double(rcf, rdg.encode_points(left))  # general Z
    Q = ref_ec.ec_double(rcf, Qa)
    tP, tQ, tQa = _t(P), _t(Q), _t(Qa)
    want = ref_ec.ec_add(rcf, P, Q)
    assert _same(want, ec.ec_add(cf, tP, tQ))
    assert _same(want, cuda_ec.ec_add_plain(cf, tP, tQ))
    assert _affine(_decode(dg, ec.ec_add(cf, tP, tQ))) == \
        _affine(host.double(host.add(x, y)) for x, y in zip(left, right))
    qinf = cf.is_zero(tQa[2])
    want = ref_ec.ec_add(rcf, P, Qa)
    assert _same(want, cuda_ec.ec_madd(cf, tP, (tQa[0], tQa[1], qinf)))
    assert _same(want, cuda_ec.ec_madd_plain(cf, tP, (tQa[0], tQa[1], qinf)))
    # an infinite accumulator takes (x2, y2, one), or (x2, y2, 0) if flagged
    pinf = ec.point_infinity(cf, (len(right),))
    got = cuda_ec.ec_madd(cf, pinf, (tQa[0], tQa[1], qinf))
    assert _same(Qa, got) and _same(ref_ec.ec_add(rcf, rdg.p_identity((8,)), Qa), got)
    assert _same(ref_ec.ec_double(rcf, P), ec.ec_double(cf, tP))
    assert _same(ref_ec.ec_add(rcf, P, P), ec.ec_add(cf, tP, tP))  # t + t
    assert _same(ref_ec.ec_neg(rcf, P), ec.ec_neg(cf, tP))
    (x, y, m), (tx, ty, tm) = ref_ec.to_affine(rcf, P), ec.to_affine(cf, tP)
    assert _same((x, y), (tx, ty)) and np.array_equal(np.asarray(m), tm.numpy())
    assert _same(rdg.p_identity((3,)), ec.point_infinity(cf, (3,)))


def _leaves(group, n, seed):
    """n affine leaves with repeats (p + p inside a block) and infinities."""
    rdg = ref_device_group(CURVE, group)
    pts = _points(group, 3, seed)
    rng = np.random.default_rng(seed)
    sel = [pts[i] for i in np.sort(rng.integers(0, 3, size=n))]
    for i in rng.integers(0, n, size=max(1, n // 8)):
        sel[i] = rdg.host_group.infinity
    return sel, rdg.encode_points(sel)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_block_totals_match_jax_loop(group):
    """K9b and K9c (plain) at G = 8 blocks of B = 32 against an eager loop
    of the JAX package's `ec_add` from infinity (the reference of
    `tests/test_msm_scan_kernels.py:47-56`); K9c over general-Z points.
    The JAX side sees the shapes of the test above only, so its eager
    primitives are compiled once."""
    rdg, dg = ref_device_group(CURVE, group), device_group(CURVE, group, "cpu")
    cf = dg.cf
    B, G = 32, 8
    _, enc = _leaves(group, G * B, 3)
    aff = _t(enc)
    jac = dg.p_double(aff)
    for elems, got in (
        (aff, cuda_ec.block_totals_madd(cf, (aff[0], aff[1], cf.is_zero(aff[2])), B)),
        (jac, cuda_ec.block_totals_add(cf, jac, B)),
    ):
        blocked = [to_numpy(c).reshape(G, B, *c.shape[1:]) for c in elems]
        acc = rdg.p_identity((G,))
        for b in range(B):
            acc = ref_ec.ec_add(rdg.cf, acc, tuple(c[:, b] for c in blocked))
        assert _same(acc, got)


def _running_sums(host, pts):
    out, acc = [], host.infinity
    for p in pts:
        acc = host.add(acc, p)
        out.append(acc)
    return out


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_prefix_boundaries_with_a_k9c_level(group, monkeypatch):
    """`_prefix_boundary_leaf` and `_prefix_boundary_jac` against host-int
    running sums, on two rows of 128 sorted leaves, with the tiling
    thresholds patched small: K9b runs on the leaves, a K9c level on their
    block totals, and a Hillis-Steele scan on the top."""
    monkeypatch.setattr(msm, "_LEAF_GROUPS", 1)
    monkeypatch.setattr(msm, "_JAC_TOP", 2)
    calls = []
    for name in ("block_totals_madd", "block_totals_add"):
        fn = getattr(msm, name)
        monkeypatch.setattr(msm, name, lambda cf, e, B, fn=fn, name=name:
                            calls.append((name, e[0].shape[0])) or fn(cf, e, B))
    dg = device_group(CURVE, group, "cpu")
    host = dg.host_group
    rows = [_leaves(group, 128, 11 + j) for j in range(2)]
    leaves = tuple(torch.stack([_t(enc)[i] for _, enc in rows]) for i in range(3))
    leaves = leaves[:2] + (dg.cf.is_zero(leaves[2]),)
    q = torch.tensor([[-1, 0, 31, 32, 100, 127], [127, 7, -1, 64, 96, 33]])
    got = _decode(dg, dg._prefix_boundary_leaf(leaves, q))
    want = []
    for (pts, _), qs in zip(rows, q.tolist()):
        sums = _running_sums(host, pts)
        want += [host.infinity if i < 0 else sums[i] for i in qs]
    assert _affine(got) == _affine(want)
    assert calls == [("block_totals_madd", 256), ("block_totals_add", 64)]
    # the Jacobian level alone, over general-Z points (40 padded to 64)
    pts = dg.p_double(dg._promote_leaves(tuple(c[:, :40] for c in leaves)))
    qj = torch.tensor([[39, 0, 12], [-1, 38, 31]])
    got = _decode(dg, dg._prefix_boundary_jac(pts, qj))
    want = []
    for (hpts, _), qs in zip(rows, qj.tolist()):
        sums = _running_sums(host, [host.double(p) for p in hpts[:40]])
        want += [host.infinity if i < 0 else sums[i] for i in qs]
    assert _affine(got) == _affine(want)


def _msm_inputs(group, n, seed):
    pts = _points(group, 6, seed)
    rng = np.random.default_rng(seed)
    sel = [pts[i] for i in rng.integers(0, 6, size=n)]
    sel[1] = sel[n - 2] = _host(group)[0].infinity
    r = CURVE.fr.modulus
    sc = [int(rng.integers(0, 1 << 62)) * (1 << 190) % r for _ in range(n)]
    sc[0], sc[3], sc[4] = 0, r - 1, 1
    return sel, sc


@pytest.mark.parametrize("group,n", [("g1", 64), ("g2", 16)])
def test_jacobian_msm_matches_host_and_rcb(group, n, monkeypatch):
    """The Jacobian engine's MSM (affine leaves, batched windows, the
    prefix_at_indices branch at this width) against the host-int MSM, and
    in G1 against the port's RCB engine on the same inputs; padding to a
    power of two and points wider than the scalars included. (The RCB
    engine's G2 MSM costs some 7 s of plain adds on this CPU; it equals
    the host MSM in `test_torch_msm.py`, and the engines' G2 MSMs meet in
    the Groth16 proofs of `test_torch_groth16.py`.)"""
    pts, sc = _msm_inputs(group, n, 5)
    dg = device_group(CURVE, group, "cpu")
    P = dg.encode_points(pts)
    S = dg.encode_scalars(sc[:-1])  # the points one row wider
    want = _affine([dg.host_group.msm(pts[:-1], sc[:-1])])
    if group == "g1":
        assert _affine([dg.decode_point(dg.msm(P, S))]) == want
    monkeypatch.setattr(dg, "_use_rcb", False)
    got = dg.decode_point(dg.msm(P, S))
    assert _affine([got]) == want and not got.infinity


def test_jacobian_fixed_base_matches_host_mul(monkeypatch):
    """K9a's fixed-base chain (plain) over the window table, one call for
    all the scalars, then the normalization in slices (patched to 4 points,
    so the 16 padded points take four): affine-encoded points padded to a
    power of two."""
    dg = device_group(CURVE, "g1", "cpu")
    monkeypatch.setattr(dg, "_use_rcb", False)
    monkeypatch.setattr(msm, "_NORMALIZE_CHUNK", 4)
    r = CURVE.fr.modulus
    sc = [0, 1, 2, r - 1, 5 << 200, 3, 1 << 64, 7, 11, 13]
    out = dg.fixed_base_msm(dg.fixed_base_table(CURVE.g1_gen), dg.encode_scalars(sc),
                            pad_output=True)
    assert out[0].shape[0] == 16
    got = dg.decode_points_host(out)
    assert _affine(got[:10]) == _affine(CURVE.g1.mul(CURVE.g1_gen, s) for s in sc)
    assert all(p.infinity for p in got[10:])
    z = out[2]
    assert bool(((z == dg.cf.ones((16,))).all(1) | (z == 0).all(1)).all())


def test_jacobian_engine_refuses_a_nonzero():
    """The Jacobian formulas are a = 0 formulas: a group with a != 0 (which
    the reference would send to them, `ops/msm.py:363`) is refused."""
    curve = copy.copy(port_curve("bn254"))
    g1 = curve.g1
    curve.g1 = WeierstrassGroup(g1.f, 1, g1.b, g1.order)
    dg = DeviceCurveGroup(curve, "g1", "cpu")
    assert dg._use_rcb is False
    P = dg.encode_points([curve.g1_gen] * 2)
    with pytest.raises(ValueError, match="a = 0"):
        dg.msm(P, dg.encode_scalars([1, 2]))
    with pytest.raises(ValueError, match="a = 0"):
        dg.fixed_base_msm(None, dg.encode_scalars([1, 2]))
    assert device_group(port_curve("bn254"), "g1", "cpu")._use_rcb is True


@pytest.mark.parametrize("fn", ["ec_add", "ec_madd", "block_totals_madd",
                                "block_totals_add"])
def test_wrappers_refuse_non_cpu_tensors_without_a_kernel(fn):
    """A wrapper takes the plain version only for CPU tensors; any other
    tensor goes to its kernel's operand checks, which refuse a non-CUDA
    one before anything is built or launched."""
    cf = device_group(CURVE, "g2", "cpu").cf
    pt = tuple(torch.empty((64, 2, 16), dtype=torch.int32, device="meta")
               for _ in range(3))
    flags = torch.zeros((64,), dtype=torch.bool, device="meta")
    args = {"ec_add": (pt, pt), "ec_madd": (pt, (pt[0], pt[1], flags)),
            "block_totals_madd": ((pt[0], pt[1], flags), 32),
            "block_totals_add": (pt, 32)}[fn]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(cuda_ec, fn)(cf, *args)

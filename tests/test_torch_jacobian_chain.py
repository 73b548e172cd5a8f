"""K9a's fixed-base chain and K8's chain entry of the port's Jacobian MSM
engine on the CPU (their plain versions): the fixed-base chain against the
JAX package's `_fixed_base_impl` (eager, the Jacobian branch) and against
the per-window loop of elementwise K9a it replaced, after normalization,
limb for limb, G1 and G2, with the edge scalars 0, r - 1, a run of zero
digits, every even digit zero and every digit 255; the chain entry against
an eager loop of the JAX package's `ec_add` with infinite, P == -Q and
P == Q accumulators, bit for bit; `chip_smoke.k8_shapes` against the K8
and chain calls of a CPU Jacobian MSM, and `chip_smoke.leaf_shapes`
against its elementwise K9a calls in the leaf branch (each MSM equal to
the host ints); the wrappers' copies of the team's constants; the
wrappers' refusals. Tolerance: none (canonical limbs, exact points)."""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckb_zkp_tpu.host.pairing import get_curve
from ckb_zkp_tpu.ops import ec as ref_ec
from ckb_zkp_tpu.ops.msm import device_group as ref_device_group
from ckb_zkp_tpu_torch.host.pairing import get_curve as port_curve
from ckb_zkp_tpu_torch.ops import cuda_ec, ec, msm
from ckb_zkp_tpu_torch.ops.limbs import to_numpy, to_torch
from ckb_zkp_tpu_torch.ops.msm import device_group

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
CURVE = get_curve("bn254")
PORT = port_curve("bn254")
R = CURVE.fr.modulus


def _scalars() -> list:
    """The edge scalars, then two uniform ones (eight in all)."""
    rng = np.random.default_rng(11)
    words = rng.integers(0, 1 << 63, size=(3, 4), dtype=np.uint64)
    u = [sum(int(w) << (64 * j) for j, w in enumerate(row)) % R for row in words]
    digits_8_to_23 = ((1 << 128) - 1) << 64
    even_digits = sum(0xFF << (16 * k) for k in range(16))
    s = [0, R - 1, u[0] & ~digits_8_to_23, u[1] & ~even_digits, (0x30 << 248) - 1, u[2], 1, 7]
    assert all(0 <= x < R for x in s)
    return s


def _gen(dg):
    return dg.curve.g1_gen if dg.group == "g1" else dg.curve.g2_gen


def _window_loop(cf, X, Y, sc):
    """The Jacobian fixed-base MSM before K9a's fixed-base kernel: a window
    at a time the 8-bit digits d, the gathered rows X[w][d], Y[w][d] and the
    elementwise K9a (plain) with the flag d == 0, from infinity."""
    s64 = sc.to(torch.int64)
    acc = ec.point_infinity(cf, (sc.shape[0],))
    for w in range(X.shape[0]):
        d = (s64[:, w // 2] >> (8 * (w % 2))) & 255
        acc = cuda_ec.ec_madd_plain(cf, acc, (X[w][d], Y[w][d], d == 0))
    return acc


def _aff(pts):
    return [(True, None, None) if p.infinity else (False, p.x, p.y) for p in pts]


def _equal(port, ref) -> bool:
    return all(np.array_equal(to_numpy(p), np.asarray(jax.device_get(r)))
               for p, r in zip(port, ref))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fixed_base_chain_matches_reference_and_window_loop(group):
    """After `_normalize`, the fixed-base chain (plain) equals the JAX
    package's `_fixed_base_impl` on its Jacobian branch (eager, the same
    table) and the per-window loop, limb for limb. Before it, the chain
    equals the loop except for the zero scalar, where the loop keeps row
    0's (X, Y, 0) and the chain (one, one, 0): two representatives of
    infinity."""
    rdg = ref_device_group(CURVE, group)
    dg = device_group(PORT, group, "cpu")
    table = dg.fixed_base_table(_gen(dg))
    rtable = rdg.fixed_base_table(CURVE.g1_gen if group == "g1" else CURVE.g2_gen)
    assert _equal(table, rtable)
    sc = dg.encode_scalars(_scalars())
    X, Y, _ = table
    chain = cuda_ec.ec_fixed_base(dg.cf, X, Y, sc)  # plain on CPU tensors
    assert _equal(chain, cuda_ec.ec_fixed_base_plain(dg.cf, X, Y, sc))
    loop = _window_loop(dg.cf, X, Y, sc)
    assert all(torch.equal(a[1:], b[1:]) for a, b in zip(chain, loop))
    assert torch.equal(chain[0][0], dg.cf.ones(())) and not chain[2][0].any()
    assert torch.equal(loop[0][0], X[0][0]) and not loop[2][0].any()
    got = dg._normalize(chain)
    assert all(torch.equal(a, b) for a, b in zip(got, dg._normalize(loop)))
    rdg._use_rcb = False
    try:
        want = rdg._fixed_base_impl(rtable, jnp.asarray(to_numpy(sc)))
    finally:
        rdg._use_rcb = True
    assert _equal(got, want)
    assert not got[0][0].any() and not got[1][0].any() and not got[2][0].any()
    host = dg.host_group
    assert _aff(dg.decode_points_host(got)) == _aff(host.mul(_gen(dg), s) for s in _scalars())


def _host_points(group, n, seed):
    host, gen = (CURVE.g1, CURVE.g1_gen) if group == "g1" else (CURVE.g2, CURVE.g2_gen)
    ks = np.random.default_rng(seed).integers(2, 1 << 62, size=n)
    return host, [host.mul(gen, int(k)) for k in ks]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_chain_matches_jax_loop_with_edge_accumulators(group):
    """K8's chain (plain) over k = 4 points and rounds of 2, 0 and 3
    doublings against an eager loop of the JAX package's `ec_add` (t + t
    for a doubling), bit for bit: point 0 starts at infinity (its
    doublings keep it there, as ec_add(inf, inf) returns q); point 1's
    first addend is the negation of its doubled start (P == -Q, whose sum
    has Z = 0, then an infinite accumulator takes the next addend); point
    2's first addend equals its doubled start (P == Q doubles); point 3's
    second addend is infinite. The host ints agree."""
    rdg, dg = ref_device_group(CURVE, group), device_group(PORT, group, "cpu")
    host, pts = _host_points(group, 12, 5)
    start = [host.infinity, pts[0], pts[1], pts[2]]
    dbl = [2, 0, 3]

    def quad(p):
        return host.double(host.double(p))

    addends = [[pts[3], host.neg(quad(pts[0])), quad(pts[1]), pts[4]],
               [pts[5], pts[6], pts[7], host.infinity],
               [pts[8], pts[9], pts[10], pts[11]]]
    enc = rdg.encode_points
    init = ref_ec.ec_double(rdg.cf, enc(start))  # general Z
    radd = [ref_ec.ec_double(rdg.cf, enc(a)) for a in addends]
    t_init = tuple(to_torch(np.asarray(c), "cpu") for c in init)
    t_add = tuple(torch.stack([to_torch(np.asarray(a[i]), "cpu") for a in radd])
                  for i in range(3))
    got = cuda_ec.ec_add_chain(dg.cf, t_init, t_add, dbl)
    acc = init
    for r, d in enumerate(dbl):
        for _ in range(d):
            acc = ref_ec.ec_add(rdg.cf, acc, acc)
        acc = ref_ec.ec_add(rdg.cf, acc, radd[r])
    assert _equal(got, acc)
    loop = t_init
    for r, d in enumerate(dbl):
        for _ in range(d):
            loop = cuda_ec.ec_add_plain(dg.cf, loop, loop)
        loop = cuda_ec.ec_add_plain(dg.cf, loop, tuple(a[r] for a in t_add))
    assert all(torch.equal(a, b) for a, b in zip(got, loop))
    want = []
    for i, p in enumerate(start):
        p = host.double(p)
        for r, d in enumerate(dbl):
            for _ in range(d):
                p = host.double(p)
            p = host.add(p, host.double(addends[r][i]))
        want.append(p)
    assert _aff(dg.decode_points_host(got)) == _aff(want)


@pytest.mark.parametrize("group,log2,nwin,batch", [("g1", 6, 5, 2), ("g2", 6, 3, 2)])
def test_k8_shapes_are_the_msm_launches(group, log2, nwin, batch, monkeypatch):
    """A CPU Jacobian MSM over 2^log2 points with `nwin` windows of 4 bits
    (the window width patched small, and the scalars below 2^(4 nwin)),
    `batch` of them a window batch (the last batch holds fewer), and the
    tiling thresholds as `chip_smoke.jacobian_engine` scales them at that
    size (a K9c level on the block totals): its K8 calls by point count and
    its chain calls by point count are `k8_shapes`', and it equals the
    host-int MSM."""
    shift = 20 - log2
    c = 4
    monkeypatch.setattr(msm, "_FIXED_BASE_BITS", c)
    monkeypatch.setattr(msm, "_LEAF_GROUPS", max(1, msm._LEAF_GROUPS >> shift))
    monkeypatch.setattr(msm, "_JAC_TOP", max(1, msm._JAC_TOP >> shift))
    monkeypatch.setattr(msm, "_WINDOW_BATCH_POINTS", batch << log2)
    adds, chains = {}, {}
    real_add, real_chain = msm.DeviceCurveGroup.p_add, msm.ec_add_chain

    def rec_add(self, a, b):
        n = int(np.prod(torch.broadcast_shapes(a[0].shape[:-self.cf.ext], b[0].shape[:-self.cf.ext])))
        adds[n] = adds.get(n, 0) + 1
        return real_add(self, a, b)

    def rec_chain(cf, init, addends, dbl):
        chains[init[0].shape[0]] = chains.get(init[0].shape[0], 0) + 1
        return real_chain(cf, init, addends, dbl)

    monkeypatch.setattr(msm.DeviceCurveGroup, "p_add", rec_add)
    monkeypatch.setattr(msm, "ec_add_chain", rec_chain)
    dg = msm.DeviceCurveGroup(PORT, group, "cpu")
    dg._use_rcb = False
    dg.nwindows = nwin
    host, pts = _host_points(group, 1 << log2, 9)
    pts[3] = host.infinity
    rng = np.random.default_rng(4)
    sc = [int(x) for x in rng.integers(0, 1 << (c * nwin), size=1 << log2)]
    sc[0], sc[1] = 0, (1 << (c * nwin)) - 1
    got = dg.decode_point(dg.msm(dg.encode_points(pts), dg.encode_scalars(sc)))
    assert _aff([got]) == _aff([host.msm(pts, sc)])
    want_adds, want_chains = chip_smoke.k8_shapes(log2, c * nwin)
    assert sorted(adds.items(), key=lambda kv: -kv[0]) == want_adds
    assert sorted(chains.items(), key=lambda kv: -kv[0]) == want_chains


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_leaf_shapes_are_the_msm_k9a_launches(group, monkeypatch):
    """A CPU Jacobian MSM at `chip_smoke.leaf_shapes`' width, with
    _LEAF_GROUPS patched to 128 (2048 points: the leaf branch, above the
    Hillis-Steele width) and 3 windows of 4 bits: its elementwise K9a
    calls are `leaf_shapes`' count and width, and it equals the host ints
    (16 host points repeated, one at infinity, so the host sum is 16
    scalar multiples)."""
    c, nwin = 4, 3
    monkeypatch.setattr(msm, "_FIXED_BASE_BITS", c)
    monkeypatch.setattr(msm, "_LEAF_GROUPS", 128)
    widths = []
    real = msm.ec_madd

    def rec(cf, p, q):
        widths.append(int(np.prod(q[2].shape)))
        return real(cf, p, q)

    monkeypatch.setattr(msm, "ec_madd", rec)
    n, width, launches = chip_smoke.leaf_shapes(c * nwin)
    assert n == 2048
    dg = msm.DeviceCurveGroup(PORT, group, "cpu")
    dg._use_rcb = False
    dg.nwindows = nwin
    host, base = _host_points(group, 16, 12)
    base[15] = host.infinity
    rng = np.random.default_rng(6)
    sc = [int(x) for x in rng.integers(0, 1 << (c * nwin), size=n)]
    want = host.infinity
    for j, b in enumerate(base):
        want = host.add(want, host.mul(b, sum(sc[j::16])))
    P = tuple(t[torch.arange(n) % 16] for t in dg.encode_points(base))
    got = dg.decode_point(dg.msm(P, dg.encode_scalars(sc)))
    assert _aff([got]) == _aff([want])
    assert widths == [width] * launches


def test_team_constants_match_the_header():
    """The wrappers' copies of `csrc/ec_team.cuh`'s constants: the G2
    split bound (lanes a point, `ec_team_lanes`) and the chain's rounds."""
    src = open(os.path.join(REPO, "ckb_zkp_tpu_torch", "csrc", "ec_team.cuh")).read()
    assert int(re.search(r"kEcSplitMax = (\d+);", src).group(1)) == cuda_ec.EC_SPLIT_MAX
    assert int(re.search(r"kChainMax = (\d+);", src).group(1)) == cuda_ec.CHAIN_MAX
    g1, g2 = (device_group(PORT, g, "cpu").cf for g in ("g1", "g2"))
    m = cuda_ec.EC_SPLIT_MAX
    assert [cuda_ec.ec_team_lanes(g2, k) for k in (1, m, m + 1)] == [16, 16, 4]
    assert [cuda_ec.ec_team_lanes(g1, k) for k in (1, m, m + 1)] == [4, 4, 4]


def test_chain_and_fixed_base_wrappers_refuse():
    """The chain and the fixed-base wrappers take the plain version only
    for CPU tensors (any other goes to the kernel's operand checks, which
    refuse a non-CUDA one); the chain refuses more than CHAIN_MAX rounds,
    a doubling count above 255 and addends of another shape; the
    fixed-base chain a table or scalars of another shape."""
    cf = device_group(PORT, "g2", "cpu").cf
    pt = tuple(torch.empty((4, 2, 16), dtype=torch.int32, device="meta") for _ in range(3))
    add = tuple(torch.empty((2, 4, 2, 16), dtype=torch.int32, device="meta")
                for _ in range(3))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ec.ec_add_chain(cf, pt, add, [8, 0])
    with pytest.raises(ValueError, match="rounds"):
        cuda_ec.ec_add_chain(cf, pt, add, [1] * (cuda_ec.CHAIN_MAX + 1))
    with pytest.raises(ValueError, match="rounds"):
        cuda_ec.ec_add_chain(cf, pt, add, [256, 0])
    with pytest.raises(ValueError, match="operand"):
        cuda_ec.ec_add_chain(cf, pt, add, [8, 0, 1])
    X = torch.empty((32, 256, 2, 16), dtype=torch.int32, device="meta")
    sc = torch.empty((4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ec.ec_fixed_base(cf, X, X, sc)
    with pytest.raises(ValueError, match="table"):
        cuda_ec.ec_fixed_base(cf, X[:16], X[:16], sc)
    with pytest.raises(ValueError, match="scalars"):
        cuda_ec.ec_fixed_base(cf, X, X, sc[:, :8])

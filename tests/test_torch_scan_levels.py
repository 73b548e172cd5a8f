"""The K3/K4 levels and K5 shapes of the port's RCB MSM:
`chip_smoke.scan_levels` against the (M, B) that `_boundary_before` and
`_reduce_pts` really pass to `cuda_rcb.scan_prefix_add` / `scan_total_add`,
`chip_smoke.k5_shapes` against the point counts of its `rg.add` calls, and
the plain K3/K4 at the tail B = 2 and at a ragged chain count against the
reference's CPU fallbacks (`ops/msm.py` `_full_prefix`, `_reduce_pts`),
bit for bit."""

import math
import os
import random
import sys
import types

import jax
import numpy as np
import pytest
import torch

from ckb_zkp_tpu.host.pairing import get_curve
from ckb_zkp_tpu.ops import msm as ref_msm
from ckb_zkp_tpu.ops.msm import device_group as ref_device_group
from ckb_zkp_tpu.ops.rcb import rcb_group as ref_rcb_group
from ckb_zkp_tpu_torch.host.pairing import get_curve as port_curve
from ckb_zkp_tpu_torch.ops import cuda_rcb, msm
from ckb_zkp_tpu_torch.ops.limbs import to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
CURVE = get_curve("bn254")


@pytest.mark.parametrize("rcb_b,top,small,n,batch,full", [
    (4, 8, 32, 64, 7, [("scan_prefix_add", 112, 4), ("scan_total_add", 1792, 4),
                       ("scan_total_add", 448, 4), ("scan_total_add", 112, 16)]),
    (16, 4, 8, 128, 7, [("scan_prefix_add", 112, 16), ("scan_total_add", 1792, 16),
                        ("scan_total_add", 112, 16)]),
])
def test_scan_levels_are_the_msm_launches(monkeypatch, rcb_b, top, small, n, batch, full):
    """A CPU MSM over n points with 64-bit scalars (8-bit windows, 8 of
    them, 7 a batch) with the block, the tops, the batch and the scalar
    limbs patched small: K3 runs one level, K4
    two levels and a B = rest tail (first case) or one level and none (one
    point left, second case), and the last batch holds fewer windows than
    the others. The K3/K4 calls, batch by batch, are scan_levels', the K5
    calls (`rg.add`) by point count are k5_shapes', and the MSM equals the
    host-int one."""
    monkeypatch.setattr(msm, "_RCB_B", rcb_b)
    monkeypatch.setattr(msm, "_TOP_MAX", top)
    monkeypatch.setattr(msm, "_SMALL_SCAN_MAX", small)
    monkeypatch.setattr(msm, "_WINDOW_BATCH_POINTS", batch * n)
    calls = []
    for name in ("scan_prefix_add", "scan_total_add"):
        real = getattr(cuda_rcb, name)

        def rec(rg, pts, B, _real=real, _name=name):
            calls.append((_name, pts[0].shape[0], B))
            return _real(rg, pts, B)

        monkeypatch.setattr(msm, name, rec)
    curve = port_curve("bn254")
    dg = msm.device_group(curve, "g1", "cpu")
    adds = {}
    real_add = dg.rg.add

    def rec_add(p, q):
        npts = math.prod(torch.broadcast_shapes(p[0].shape, q[0].shape)[:-1])
        adds[npts] = adds.get(npts, 0) + 1
        return real_add(p, q)

    monkeypatch.setattr(dg.rg, "add", rec_add)
    bits = 64  # a quarter of the scalar limbs: 8 windows
    monkeypatch.setattr(dg, "fr", types.SimpleNamespace(L=bits // 16, spec=dg.fr.spec))
    host = dg.host_group
    prng = random.Random(5)
    log2 = n.bit_length() - 1
    base = [host.mul(curve.g1_gen, prng.randrange(1, CURVE.fr.modulus)) for _ in range(8)]
    pts = [base[i % 8] for i in range(n)]
    sc = [prng.randrange(1 << bits) for _ in range(n)]
    got = dg.decode_point(dg.msm(dg.encode_points(pts), dg.encode_scalars(sc)))
    want = host.msm(pts, sc)  # the cached group may hold either package's curve
    assert (got.infinity, got.x, got.y) == (want.infinity, want.x, want.y)
    nwin = bits // 8
    assert nwin % batch  # a short last batch
    assert chip_smoke.scan_levels(log2, bits) == full
    want = []
    for w0 in range(0, nwin, batch):
        want += chip_smoke.scan_levels(log2, batch=min(batch, nwin - w0))
    assert calls == want
    assert sorted(adds.items(), key=lambda kv: -kv[0]) == chip_smoke.k5_shapes(log2, bits)


def test_k5_shapes_at_2_20():
    assert chip_smoke.k5_shapes(20) == [(131072, 24), (64, 40), (2, 144), (1, 272)]


def test_scan_levels_at_2_20():
    assert chip_smoke.scan_levels(20) == [
        ("scan_prefix_add", 65536, 32), ("scan_prefix_add", 2048, 32),
        ("scan_total_add", 131072, 32), ("scan_total_add", 4096, 32),
        ("scan_total_add", 128, 32), ("scan_total_add", 4, 2)]


def _groups(group):
    rdg = ref_device_group(CURVE, group)
    return rdg, ref_rcb_group(rdg), msm.device_group(CURVE, group, "cpu")


def _proj_points(dg, group, n, seed):
    """n general projective points (Z not one, a few at infinity), formed
    by the port's plain add (held to the reference's in test_torch_rcb)."""
    host = dg.host_group
    gen = CURVE.g1_gen if group == "g1" else CURVE.g2_gen
    rng = np.random.default_rng(seed)
    pts = [host.mul(gen, int(k)) for k in rng.integers(2, 1 << 62, size=8)]
    left = [pts[i] for i in rng.integers(0, 8, size=n)]
    right = [pts[i] for i in rng.integers(0, 8, size=n)]
    for i in rng.integers(0, n, size=max(1, n // 8)):
        left[i] = host.infinity
    right[0] = host.neg(left[0])
    rg = dg.rg
    return rg.add(rg.from_affine_enc(dg.encode_points(left)),
                  rg.from_affine_enc(dg.encode_points(right)))


def _same(ref_pt, port_pt):
    return all(np.array_equal(np.asarray(jax.device_get(a)), to_numpy(b))
               for a, b in zip(ref_pt, port_pt))


def _np(pt):
    return tuple(to_numpy(c) for c in pt)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k4_tail_b2_matches_reference_reduce(group):
    """The last `_reduce_pts` launch of a 2^20 batch: M = 4, B = 2, each
    chain the reference's CPU `_reduce_pts` of its two points."""
    rdg, rrg, dg = _groups(group)
    pts = _proj_points(dg, group, 4, 71)
    T = cuda_rcb.scan_total_add_plain(dg.rg, pts, 2)
    chains = tuple(c.reshape(2, 2, *c.shape[1:]) for c in _np(pts))
    want = jax.vmap(lambda *p: ref_msm._reduce_pts(rrg, p, 2))(*chains)
    assert _same(want, T)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_ragged_chains_match_reference_fallback(group):
    """13 chains of B = 8 (a count no team block divides): K3's W is each
    block's reference `_full_prefix` (a sequential scan from the identity),
    and K3's and K4's T its last element."""
    rdg, rrg, dg = _groups(group)
    G, B = 13, 8
    pts = _proj_points(dg, group, G * B, 83)
    W, T = cuda_rcb.scan_prefix_add_plain(dg.rg, pts, B)
    T4 = cuda_rcb.scan_total_add_plain(dg.rg, pts, B)
    assert all(torch.equal(a, b) for a, b in zip(T, T4))
    blocks = tuple(c.reshape(G, B, *c.shape[1:]) for c in _np(pts))
    want_w = jax.vmap(lambda *p: ref_msm._full_prefix(rrg, p, B))(*blocks)
    assert _same(tuple(c.reshape(G * B, *c.shape[2:]) for c in want_w), W)
    assert _same(tuple(c[:, -1] for c in want_w), T)

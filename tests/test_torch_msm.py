"""The port's Pippenger MSM (plain versions of K2-K5 on the CPU) and its
fixed-base MSM against the reference. MSM results are compared as affine
points: the reference sorts unstably, so projective coordinates may differ.

The 16-bit-window branch (N >= 2^18) is left to the card: its 65536-bucket
tail is too heavy for the plain path here; chip_smoke.py's 2^20 prove runs
it."""

import os

import jax
import numpy as np
import pytest
import torch

from ckb_zkp_tpu.host.pairing import get_curve
from ckb_zkp_tpu.ops.msm import device_group as ref_device_group
from ckb_zkp_tpu_torch.ops.limbs import to_torch
from ckb_zkp_tpu_torch.ops.msm import device_group

torch.set_num_threads(1)
CURVE = get_curve("bn254")


@pytest.fixture(scope="module", autouse=True)
def reference_host_cutoff():
    """The JAX package's cached BN254 device groups at the host cutoff it
    picks itself (`ckb_zkp_tpu/ops/msm.py:374-379`) for the module that
    imports this fixture. tests/test_msm.py sets the cutoff to 0 on these
    groups and leaves it so: in the same worker, every small MSM of a later
    reference run would then compile a device MSM, minutes on the CPU, where
    the JAX package runs it on host ints."""
    cutoff = int(os.environ.get("CKB_ZKP_TPU_HOST_MSM_MAX",
                                "512" if jax.default_backend() == "cpu" else "4096"))
    groups = [ref_device_group(CURVE, g) for g in ("g1", "g2")]
    saved = [g.small_host_threshold for g in groups]
    for g in groups:
        g.small_host_threshold = cutoff
    yield
    for g, s in zip(groups, saved):
        g.small_host_threshold = s


def _affine(p):
    return (True, None, None) if p.infinity else (False, p.x, p.y)


def _inputs(group, n, seed):
    """Points with repeats and infinities, scalars with zeros and r - 1."""
    host = CURVE.g1 if group == "g1" else CURVE.g2
    gen = CURVE.g1_gen if group == "g1" else CURVE.g2_gen
    rng = np.random.default_rng(seed)
    r = CURVE.fr.modulus
    base = [host.mul(gen, int(k)) for k in rng.integers(2, 1 << 62, size=12)]
    pts = [base[i] for i in rng.integers(0, 12, size=n)]
    for i in rng.integers(0, n, size=4):
        pts[i] = host.infinity
    words = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64)
    sc = [sum(int(w) << (64 * j) for j, w in enumerate(row)) % r for row in words]
    sc[0], sc[1], sc[2] = 0, r - 1, 1
    for i in rng.integers(0, n, size=4):
        sc[i] = 0
    return pts, sc


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_matches_reference_msm(group):
    """N = 200 against the reference DeviceCurveGroup.msm, fed the reference's
    own encodings (the points are padded 8 rows wider than the scalars)."""
    pts, sc = _inputs(group, 200, 1)
    rdg = ref_device_group(CURVE, group)
    P = rdg.encode_points(pts)
    S = rdg.encode_scalars(sc)
    want = rdg.decode_point(rdg.msm(P, S))
    dg = device_group(CURVE, group, "cpu")
    extra = dg.encode_points(pts[:8])
    tP = tuple(torch.cat([to_torch(np.asarray(c), "cpu"), e]) for c, e in zip(P, extra))
    got = dg.decode_point(dg.msm(tP, to_torch(S, "cpu")))
    assert _affine(got) == _affine(want)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_matches_host_msm(group):
    pts, sc = _inputs(group, 1000, 2)
    dg = device_group(CURVE, group, "cpu")
    got = dg.decode_point(dg.msm(dg.encode_points(pts), dg.encode_scalars(sc)))
    assert _affine(got) == _affine(dg.host_group.msm(pts, sc))


def test_msm_many_batches_equal_the_host_msms(monkeypatch):
    """`msm_many` groups MSMs of one window width within 2x of each other's
    length (here 3 and 40 points, then 70; one job's points 8 rows wider
    than its scalars), and each result equals the host-int MSM."""
    dg = device_group(CURVE, "g1", "cpu")
    groups = []
    real = dg._msm_rcb
    monkeypatch.setattr(dg, "_msm_rcb", lambda jobs: groups.append(
        [s.shape[0] for _, s in jobs]) or real(jobs))
    inputs = [_inputs("g1", n, 10 + n) for n in (70, 3, 40)]
    jobs = [(dg.encode_points(pts), dg.encode_scalars(sc)) for pts, sc in inputs]
    pts, sc = inputs[2]
    jobs[2] = (dg.encode_points(pts + pts[:8]), jobs[2][1])
    got = [dg.decode_point(q) for q in dg.msm_many(jobs)]
    assert groups == [[3, 48], [70]]
    want = [CURVE.g1.msm(pts, sc) for pts, sc in inputs]
    assert [_affine(p) for p in got] == [_affine(p) for p in want]


def test_msm_window_bits_follow_reference():
    dg = device_group(CURVE, "g1", "cpu")
    rdg = ref_device_group(CURVE, "g1")
    for n in (1, 1 << 17, (1 << 18) - 1, 1 << 18, 1 << 20):
        assert dg._msm_window_bits(n) == rdg._msm_window_bits(n)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fixed_base_msm_matches_host_mul(group):
    host = CURVE.g1 if group == "g1" else CURVE.g2
    gen = CURVE.g1_gen if group == "g1" else CURVE.g2_gen
    r = CURVE.fr.modulus
    rng = np.random.default_rng(3)
    sc = [0, 1, 2, r - 1] + [int(k) for k in rng.integers(1, 1 << 62, size=8)]
    sc.append(sc[-1] * (1 << 190) % r)
    dg = device_group(CURVE, group, "cpu")
    table = dg.fixed_base_table(gen)
    out = dg.fixed_base_msm(table, dg.encode_scalars(sc), pad_output=True)
    lazy = dg.fixed_base(gen)  # the reference's FixedBase: the table at first use
    assert all(torch.equal(a, b) for a, b in zip(
        dg.fixed_base_msm(lazy, dg.encode_scalars(sc), pad_output=True), out))
    assert out[0].shape[0] == 16  # pow2 padding, as the reference's rule
    got = dg.decode_points_host(out)
    assert [_affine(p) for p in got[: len(sc)]] == [_affine(host.mul(gen, s)) for s in sc]
    assert all(p.infinity for p in got[len(sc):])
    # affine encoding: Z is one or zero
    z = out[2]
    one = dg.cf.ones(z.shape[:1])
    assert bool(((z == one).flatten(1).all(1) | (z == 0).flatten(1).all(1)).all())
    ref = ref_device_group(CURVE, group)
    assert (dg.c, dg.nwindows) == (ref.c, ref.nwindows)

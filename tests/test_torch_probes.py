"""K2a and K2b (plain versions) against the reference's `_scan_prefix_madd`
fallback, the scan probes' plain kernels (column-major and g-major, CIOS
and tensor-core) against K2b and host ints, and the window probe's full
window against the prover's `_windows`, on the CPU. Eager JAX only;
projective coordinates are compared bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckb_zkp_tpu.host.pairing import get_curve
from ckb_zkp_tpu.ops import msm as ref_msm
from ckb_zkp_tpu.ops import pallas_rcb
from ckb_zkp_tpu.ops.msm import device_group as ref_device_group
from ckb_zkp_tpu.ops.rcb import rcb_group as ref_rcb_group
from ckb_zkp_tpu_torch.ops import cuda_probe, cuda_rcb
from ckb_zkp_tpu_torch.ops.limbs import (ints_to_limbs, limbs_to_ints, pack_limbs, to_numpy,
                                        to_torch)
from ckb_zkp_tpu_torch.ops.msm import _scan_prefix_madd, device_group
from ckb_zkp_tpu_torch.probes import dma, grid, mxu, scan, window

torch.set_num_threads(1)
CURVE = get_curve("bn254")


def _leaves(group, n, seed):
    """n affine leaves (X, Y, inf) of 8 random points, 1/8 of them flagged,
    as the reference's encoded arrays."""
    rdg = ref_device_group(CURVE, group)
    host = rdg.host_group
    gen = CURVE.g1_gen if group == "g1" else CURVE.g2_gen
    rng = np.random.default_rng(seed)
    pts = [host.mul(gen, int(k)) for k in rng.integers(2, 1 << 62, size=8)]
    sel = [pts[i] for i in rng.integers(0, 8, size=n)]
    for i in rng.integers(0, n, size=max(1, n // 8)):
        sel[i] = host.infinity
    X, Y, Z = rdg.encode_points(sel)
    return X, Y, np.asarray(Z).reshape(n, -1).max(axis=1) == 0


def _same(ref_pt, port_pt):
    return all(np.array_equal(np.asarray(a), to_numpy(b)) for a, b in zip(ref_pt, port_pt))


def _packed(X):
    return pack_limbs(X.reshape(X.shape[0], -1))


@pytest.mark.parametrize("group,n,B", [("g1", 96, 32), ("g2", 96, 32), ("g1", 15, 5),
                                       ("g2", 15, 5)])
def test_k2a_k2b_plain_match_reference_scan_prefix_madd(group, n, B):
    """K2a through the port's `_scan_prefix_madd` and K2b on leaves packed
    by the port's `pack_limbs` both give the reference fallback's W at
    every position and its T; on the first n - 2 leaves (padded with two
    flagged ones) K2a gives the same W and the last block's total is the
    prefix at n - 3."""
    rrg = ref_rcb_group(ref_device_group(CURVE, group))
    rg = device_group(CURVE, group, "cpu").rg
    X, Y, inf = _leaves(group, n, 50 + n)
    w_ref, T_ref = ref_msm._scan_prefix_madd(rrg, (X, Y, jnp.asarray(inf)), B)
    W_ref = w_ref(jnp.arange(n))
    tX, tY, tinf = to_torch(X, "cpu"), to_torch(Y, "cpu"), torch.as_tensor(inf)
    w_get, T = _scan_prefix_madd(rg, (tX, tY, tinf), B)
    assert _same(W_ref, w_get(torch.arange(n))) and _same(T_ref, T)
    W, T2 = cuda_rcb.scan_prefix_madd_packed(rg, _packed(tX), _packed(tY), tinf, B)
    assert _same(W_ref, W) and _same(T_ref, T2)
    w_cut, T_cut = _scan_prefix_madd(rg, (tX[:-2], tY[:-2], tinf[:-2]), B)
    assert _same(tuple(w[: n - 2] for w in W_ref), w_cut(torch.arange(n - 2)))
    assert all(torch.equal(c, torch.cat([t[:-1], w[n - 3 : n - 2]]))
               for c, t, w in zip(T_cut, T, W))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_pack_limbs_matches_reference(group):
    rdg = ref_device_group(CURVE, group)
    X, _, _ = _leaves(group, 9, 7)
    want = np.asarray(pallas_rcb.pack_limbs(ref_rcb_group(rdg), X))
    assert np.array_equal(want, to_numpy(_packed(to_torch(X, "cpu"))))


def _g1_case(n=96, B=32, seed=61):
    rg = device_group(CURVE, "g1", "cpu").rg
    X, Y, inf = _leaves("g1", n, seed)
    inf[:B] = True  # an all-flagged block
    leaves = (_packed(to_torch(X, "cpu")), _packed(to_torch(Y, "cpu")), torch.as_tensor(inf))
    return rg, leaves, cuda_rcb.scan_prefix_madd_packed(rg, *leaves, B)


@pytest.mark.parametrize("k", cuda_probe.CHAINS)
def test_probe_totals_plain_equal_k2b_totals(k):
    rg, leaves, (_, T) = _g1_case()
    got = cuda_probe.madd_totals(rg, *leaves, 32, k, 256)
    assert all(torch.equal(a, b) for a, b in zip(got, T))


def test_probe_prefix_packed_plain_unpacks_to_k2b_w():
    rg, leaves, (W, T) = _g1_case()
    Wp, Tp = cuda_probe.madd_prefix_packed(rg, *leaves, 32, 4, 32)
    assert all(w.shape == leaves[0].shape for w in Wp)
    assert all(torch.equal(cuda_rcb.unpack_coord(rg, a), b) for a, b in zip(Wp, W))
    assert all(torch.equal(a, b) for a, b in zip(Tp, T))


def test_gmajor_index_is_the_block_run_order():
    """g-major: each block of `cols` columns (a ragged last one too) holds
    its leaves as one step-major run; column-major element g*B + b goes
    there."""
    idx = cuda_probe.gmajor_index(5, 3, 2)
    assert idx.tolist() == [0, 2, 4, 1, 3, 5, 6, 8, 10, 7, 9, 11, 12, 13, 14]
    x = torch.arange(67 * 32)
    assert torch.equal(cuda_probe.from_gmajor(cuda_probe.to_gmajor(x, 32, 64), 32, 64), x)


@pytest.mark.parametrize("n,threads", [(96, 32), (67 * 32, 32)])
def test_gmajor_and_tensor_core_plain_equal_k2b(n, threads):
    """P12 and P18 (g-major totals), P13 (g-major W, X|Y|Z per leaf) and P19
    (tensor-core P-tot) on g-major-permuted inputs give K2b's T and W; at
    G = 67 and 32 columns per block the last block is ragged."""
    rg, leaves, (W, T) = _g1_case(n)
    g = scan.gmajor_leaves(*leaves, threads)
    for red in cuda_probe.REDS:
        got = cuda_probe.gmajor_totals(rg, *g, 32, threads, red)
        assert all(torch.equal(a, b) for a, b in zip(got, T)), red
    Wg, Tg = cuda_probe.gmajor_prefix(rg, *g, 32, threads)
    assert Wg.shape == (n, 24) and all(torch.equal(a, b) for a, b in zip(Tg, T))
    Wp = cuda_probe.from_gmajor(Wg, 32, threads)
    assert all(torch.equal(cuda_rcb.unpack_coord(rg, Wp[:, 8 * k: 8 * k + 8]), W[k])
               for k in range(3))
    got = cuda_probe.madd_totals(rg, *leaves, 32, 1, threads, "tc")
    assert all(torch.equal(a, b) for a, b in zip(got, T))


def test_probe_chain_mul_plain_matches_host_fold():
    df = device_group(CURVE, "g1", "cpu").fq
    p, B, G = df.spec.modulus, 8, 5
    rng = np.random.default_rng(3)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(G * B)]
    rinv = pow(df.R, -1, p)
    want = []
    for g in range(G):
        acc = vals[g * B]
        for b in range(B):
            acc = acc * vals[g * B + b] * rinv % p
        want.append(acc)
    x = to_torch(ints_to_limbs(vals, df.L), "cpu")
    for k in cuda_probe.CHAINS:
        assert limbs_to_ints(cuda_probe.chain_mul(df, x, B, k)) == want


def test_window_probe_stage_e_equals_windows():
    """The probe's full window (K2b on packed leaves and flags) equals the
    prover's `_windows` (K2, flag in bit 31) limb for limb, and its stage
    C is K2 on the same sorted leaves."""
    dg = device_group(CURVE, "g1", "cpu")
    X, Y, inf, digits = window.make_inputs(dg, 10, 8, 5, "cpu")
    assert X.shape == (1024, 16) and digits.shape == (1, 1024) and int(inf.sum()) >= 0
    window.check_window_sum(dg, X, Y, inf, digits, 8)
    stages = window.window_stages(dg, X, Y, inf, digits, 8)
    assert tuple(stages) == window.STAGES
    W, T = stages["C +K2b scan"]()
    xs, ys, fs = stages["B +gathers"]()
    assert torch.equal(fs, inf[stages["A sort"]()[0]])
    assert torch.equal(cuda_rcb.unpack_coord(dg.rg, xs), X[stages["A sort"]()[0]])
    assert len(W) == 3 and W[0].shape == (1024, 16) and T[0].shape == (32, 16)


def test_probe_kernels_refuse_what_they_do_not_take():
    """On a non-CPU tensor the wrappers launch or raise: no kernel for a
    meta tensor, none for G2, none for another K or block size."""
    rg1 = device_group(CURVE, "g1", "cpu").rg
    rg2 = device_group(CURVE, "g2", "cpu").rg
    w = torch.empty((64, 8), dtype=torch.int32, device="meta")
    f = torch.zeros((64,), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_probe.madd_totals(rg1, w, w, f, 32)
    with pytest.raises(ValueError, match="G1"):
        cuda_probe.madd_prefix_packed(rg2, w, w, f, 32)
    with pytest.raises(ValueError, match="k = 3"):
        cuda_probe.madd_totals(rg1, w, w, f, 32, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rcb.scan_prefix_madd_packed(rg1, w, w, f, 32)
    with pytest.raises(ValueError, match="multiple"):
        cuda_probe.chain_mul(rg1.df, torch.empty((65, 16), dtype=torch.int32), 32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_probe.gmajor_totals(rg1, w, w, f, 32, 64, "tc")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_probe.gmajor_prefix(rg1, w, w, f, 32)
    with pytest.raises(ValueError, match="red"):
        cuda_probe.madd_totals(rg1, w, w, f, 32, 1, 64, "mxu")
    with pytest.raises(ValueError, match="k = 1"):
        cuda_probe.madd_totals(rg1, w, w, f, 32, 2, 64, "tc")
    r = torch.empty((64, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_probe.mul_chain(rg1.df, r, r, 4, "tc")
    with pytest.raises(ValueError, match="nmul"):
        cuda_probe.mul_chain(rg1.df, r, r, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_probe.u32_ops(torch.empty((2, 8, 128), dtype=torch.int32, device="meta"), "mul")
    x8 = torch.empty((32, 16, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_probe.band_mma(cuda_probe.band_mma_matrix("meta"), x8, 8)
    with pytest.raises(ValueError, match="n_mm"):
        cuda_probe.band_mma(cuda_probe.band_mma_matrix("meta"), x8, 4)


@pytest.mark.parametrize("probe", [window, scan, mxu, grid, dma])
def test_probes_exit_nonzero_without_a_card(probe, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main([] if probe is mxu else ["--log2", "10"]) == 2
    assert "CUDA card" in capsys.readouterr().err

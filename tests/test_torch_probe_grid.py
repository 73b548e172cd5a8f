"""The grid-carried, write-only and DMA-pattern probes' kernels (P7-P11,
P20-P22) on the CPU, through their plain versions: P7, P8 and P11 against
the reference's `_scan_prefix_madd` fallback (eager JAX), T and the
unpacked W bit for bit; P9, P10 and P20-P22 against numpy; and what their
wrappers refuse. The card-only comparisons are in
`test_torch_kernels_cuda.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ckb_zkp_tpu.host.pairing import get_curve
from ckb_zkp_tpu.ops import msm as ref_msm
from ckb_zkp_tpu.ops.msm import device_group as ref_device_group
from ckb_zkp_tpu.ops.rcb import rcb_group as ref_rcb_group
from ckb_zkp_tpu_torch.ops import cuda_probe, cuda_rcb
from ckb_zkp_tpu_torch.ops.limbs import pack_limbs, to_numpy, to_torch
from ckb_zkp_tpu_torch.ops.msm import device_group
from ckb_zkp_tpu_torch.probes import dma

torch.set_num_threads(1)
CURVE = get_curve("bn254")


def _leaves(n, B, seed):
    """n G1 affine leaves of 8 random points, 1/8 of them flagged and the
    first block all flagged where there are several, as the reference's
    encoded arrays."""
    rdg = ref_device_group(CURVE, "g1")
    host = rdg.host_group
    rng = np.random.default_rng(seed)
    pts = [host.mul(CURVE.g1_gen, int(k)) for k in rng.integers(2, 1 << 62, size=8)]
    sel = [pts[i] for i in rng.integers(0, 8, size=n)]
    flagged = set(rng.integers(0, n, size=max(1, n // 8)).tolist())
    if n > B:
        flagged |= set(range(B))
    for i in flagged:
        sel[i] = host.infinity
    X, Y, Z = rdg.encode_points(sel)
    return X, Y, np.asarray(Z).max(axis=1) == 0


@pytest.mark.parametrize("n,B", [(67 * 32, 32), (5 * 64, 5), (7, 7)])
def test_grid_scans_plain_match_reference_scan_prefix_madd(n, B):
    """P7's T, and P8's and P11's W (unpacked) and T, at every option,
    equal the reference fallback's on flagged leaves; at G = 67 columns a
    tile of 32 or 64 columns and a block of 256 threads are ragged."""
    rrg = ref_rcb_group(ref_device_group(CURVE, "g1"))
    rg = device_group(CURVE, "g1", "cpu").rg
    X, Y, inf = _leaves(n, B, 80 + n)
    assert inf.any() and (n == B or inf[:B].all())
    w_ref, T_ref = ref_msm._scan_prefix_madd(rrg, (X, Y, jnp.asarray(inf)), B)
    W_ref = [np.asarray(w) for w in w_ref(jnp.arange(n))]
    T_ref = [np.asarray(t) for t in T_ref]
    leaves = tuple(pack_limbs(to_torch(c, "cpu")) for c in (X, Y)) + (torch.as_tensor(inf),)
    for t in cuda_probe.GRID_THREADS:
        T = cuda_probe.grid_totals(rg, *leaves, B, t)
        assert all(np.array_equal(to_numpy(a), b) for a, b in zip(T, T_ref))
    runs = [cuda_probe.grid_prefix(rg, *leaves, B, t) for t in cuda_probe.GRID_THREADS]
    runs += [cuda_probe.grid_prefix_tile(rg, *leaves, B, c) for c in cuda_probe.TILE_COLS]
    for W, T in runs:
        assert all(w.shape == (n, 8) for w in W)
        assert all(np.array_equal(to_numpy(cuda_rcb.unpack_coord(rg, a)), b)
                   for a, b in zip(W, W_ref))
        assert all(np.array_equal(to_numpy(a), b) for a, b in zip(T, T_ref))


def test_write_only_plain_matches_numpy():
    """P9 and P10: W = (x, y, x ^ y), in new tensors."""
    rng = np.random.default_rng(9)
    x, y = (rng.integers(-(1 << 31), 1 << 31, (67 * 32, 8), dtype=np.int64).astype(np.int32)
            for _ in range(2))
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    outs = [cuda_probe.wo_steps(tx, ty, 32)]
    outs += [cuda_probe.wo_tile(tx, ty, 32, c) for c in cuda_probe.TILE_COLS]
    for W in outs:
        assert [w.numpy().tolist() for w in W] == [x.tolist(), y.tolist(), (x ^ y).tolist()]
        assert W[0].data_ptr() != tx.data_ptr() and W[1].data_ptr() != ty.data_ptr()


@pytest.mark.parametrize("planes,m,lead", [(8, 256, 32), (3, 96, 4)])
def test_xor_plain_matches_numpy(planes, m, lead):
    """P20 (sb 8, 32), P22 on (planes, M, 128) and P21 on (B, planes,
    M/B, 128) words from the probe's generator: a ^ b."""
    (a3, b3), (a4, b4) = dma.make_inputs(m, 11, "cpu", planes, lead)
    assert a3.shape == (planes, m, 128) and a4.shape == (lead, planes, m // lead, 128)
    want3, want4 = a3.numpy() ^ b3.numpy(), a4.numpy() ^ b4.numpy()
    assert int(a3.min()) < 0 < int(a3.max())
    got3 = [cuda_probe.xor_flat(a3, b3, sb) for sb in cuda_probe.XOR_SB["flat"]]
    got3.append(cuda_probe.xor_grid2d(a3, b3, 8, lead))
    assert all(np.array_equal(g.numpy(), want3) for g in got3)
    assert np.array_equal(cuda_probe.xor_lead1(a4, b4, 8).numpy(), want4)
    assert dma.rows(1 << 10) == 256 and dma.rows(1 << 21) == 16384


def test_grid_and_dma_kernels_refuse_what_they_do_not_take():
    """On a non-CPU tensor the wrappers launch or raise: no kernel for a
    meta tensor, none for G2, none for another block size, tile width or
    sb, none for a W tile beyond a block's shared memory."""
    rg1 = device_group(CURVE, "g1", "cpu").rg
    rg2 = device_group(CURVE, "g2", "cpu").rg
    w = torch.empty((64, 8), dtype=torch.int32, device="meta")
    f = torch.zeros((64,), dtype=torch.bool, device="meta")
    for fn in (cuda_probe.grid_totals, cuda_probe.grid_prefix, cuda_probe.grid_prefix_tile):
        with pytest.raises(ValueError, match="CUDA"):
            fn(rg1, w, w, f, 32)
        with pytest.raises(ValueError, match="G1"):
            fn(rg2, w, w, f, 32)
    with pytest.raises(ValueError, match="threads = 128"):
        cuda_probe.grid_totals(rg1, w, w, f, 32, 128)
    with pytest.raises(ValueError, match="threads = 32"):
        cuda_probe.grid_prefix(rg1, w, w, f, 32, 32)
    with pytest.raises(ValueError, match="cols = 256"):
        cuda_probe.grid_prefix_tile(rg1, w, w, f, 32, 256)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_probe.grid_prefix_tile(rg1, w, w, f, 64, 64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_probe.wo_steps(w, w, 32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_probe.wo_tile(w, w, 32, 64)
    with pytest.raises(ValueError, match="threads = 256"):
        cuda_probe.wo_steps(w, w, 32, 256)
    with pytest.raises(ValueError, match="cols = 48"):
        cuda_probe.wo_tile(w, w, 32, 48)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_probe.wo_tile(w, w, 64, 64)
    with pytest.raises(ValueError, match="multiple"):
        cuda_probe.wo_steps(w, w, 48)
    a3 = torch.empty((8, 256, 128), dtype=torch.int32, device="meta")
    a4 = torch.empty((32, 8, 8, 128), dtype=torch.int32, device="meta")
    for fn, a in ((cuda_probe.xor_flat, a3), (cuda_probe.xor_grid2d, a3),
                  (cuda_probe.xor_lead1, a4)):
        with pytest.raises(ValueError, match="CUDA"):
            fn(a, a)
        with pytest.raises(ValueError, match="sb = 16"):
            fn(a, a, 16)
    with pytest.raises(ValueError, match="takes"):
        cuda_probe.xor_lead1(a3, a3)
    with pytest.raises(ValueError, match="multiple"):
        cuda_probe.xor_grid2d(a3[:, :128], a3[:, :128], 8, 32)

"""Kernel against plain version on the card: chip_smoke.py's phases 3 to 7
at a small size. Marked `cuda`; without a card they skip."""

import os
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RCB_PROVE = {"mont_mul", "scan_prefix_madd", "scan_prefix_add", "scan_total_add",
             "rcb_add"}
JAC_PROVE = {"ec_add", "ec_add_chain", "ec_block_totals_madd", "ec_block_totals_add"}
KERNELS = RCB_PROVE | JAC_PROVE | {"rcb_madd", "rcb_fixed_base", "ec_madd", "ec_fixed_base"}


@pytest.fixture
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def test_kernels_bit_equal_to_plain(smoke):
    results = {}
    smoke.phase_kernels(results, 14)  # the smallest slice whose prove launches K3
    assert set(results) == KERNELS
    assert all(r["max_abs_err"] == 0 and r["bound_ms"] > 0 for r in results.values())


def test_scan_levels_every_level_compared(smoke):
    """K3 and K4 (G1, G2) held to their plain versions at every (M, B) a
    2^14 prove launches (`scan_levels`), at the edge shapes and at the
    ragged chain counts of `SCAN_EDGE`."""
    import numpy as np

    from ckb_zkp_tpu_torch.host.pairing import get_curve

    seen = []

    def record(name, err, ms, plain_ms, what, work=None, library_ms=None):
        assert err == 0, what
        seen.append((name, what))

    levels = smoke.scan_level_checks(record, np.random.default_rng(1), get_curve("bn254"), 14)
    want = [(g, *lv) for g in ("g1", "g2") for lv in smoke.scan_levels(14)]
    assert [(r["group"], r["name"], r["M"], r["B"]) for r in levels] == want
    assert all(r["bound_ms"] > 0 and r["ms"] > 0 for r in levels)
    assert len(seen) == 2 * (2 * len(smoke.SCAN_EDGE) + len(smoke.scan_levels(14)))


def test_team_kernels_every_shape_compared(smoke):
    """K2 (leaves in order and through random orders, the G2 team boundary
    at 2048 and 2049 chains, the prove's shape through a sort order) and K5
    (1, 2, 64, 2048, 2049 and 2^14 points, then every shape of a 2^14
    prove), G1 and G2, bit for bit against their plain versions
    (`team_checks`); the G2 team is a warp up to 2048 chains or points."""
    import numpy as np

    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_rcb
    from ckb_zkp_tpu_torch.ops.msm import device_group

    seen = []

    def record(name, err, ms, plain_ms, what, work=None, library_ms=None):
        assert err == 0, what
        seen.append(name)

    curve = get_curve("bn254")
    rows = smoke.team_checks(record, np.random.default_rng(2), curve, 14)
    k5 = smoke.k5_shapes(14)
    k2 = smoke.path_shapes(14, 256)["scan_prefix_madd"]
    assert [(r["name"], r["group"], r["size"]) for r in rows] == [
        (name, g, size) for g in ("g1", "g2")
        for name, size in [("scan_prefix_madd", k2)] + [("rcb_add", n) for n, _ in k5]]
    assert seen.count("scan_prefix_madd") == 2 * (len(smoke.K2_EDGE) + 1)
    assert seen.count("rcb_add") == 2 * (len(smoke.K5_EDGE) + len(k5))
    assert all(r["bound_ms"] > 0 and r["ms"] > 0 for r in rows)
    rg2 = device_group(curve, "g2", "cuda").rg
    assert cuda_rcb.team_shape(rg2, 2048)[0] == 32 and cuda_rcb.team_shape(rg2, 2049)[0] == 8


def test_fixed_base_every_shape_compared(smoke):
    """K6's fixed-base kernel (G1, G2) bit for bit against its plain
    version at 1, 7, 2047, 2048 and 2049 points with edge scalars and at a
    2^14 setup's width, where it also equals the per-window loop it
    replaced (`fixed_base_checks`)."""
    import numpy as np

    from ckb_zkp_tpu_torch.host.pairing import get_curve

    seen = []

    def record(name, err, ms, plain_ms, what, work=None, library_ms=None):
        assert err == 0, what
        seen.append(name)

    rows, loop = smoke.fixed_base_checks(record, np.random.default_rng(3),
                                         get_curve("bn254"), 14)
    assert [(r["group"], r["n"]) for r in rows] == [("g1", 1 << 14), ("g2", 1 << 14)]
    assert seen == ["rcb_fixed_base"] * 2 * (len(smoke.FB_EDGE) + 1)
    assert loop["rcb_madd"] == 2 * 32
    assert all(r["bound_ms"] > 0 and r["ms"] > 0 and r["loop_ms"] > 0 for r in rows)


def test_jacobian_fixed_base_every_shape_compared(smoke):
    """K9a's fixed-base kernel (G1, G2) bit for bit against its plain
    version at 1, 7, 2047, 2048 and 2049 points with edge scalars and at a
    2^14 setup's width, where it also equals the per-window loop it
    replaced after normalization (`jacobian_fixed_base_checks`)."""
    import numpy as np

    from ckb_zkp_tpu_torch.host.pairing import get_curve

    seen = []

    def record(name, err, ms, plain_ms, what, work=None, library_ms=None):
        assert err == 0, what
        seen.append(name)

    rows = smoke.jacobian_fixed_base_checks(record, np.random.default_rng(4),
                                            get_curve("bn254"), 14)
    assert [(r["group"], r["n"]) for r in rows] == [("g1", 1 << 14), ("g2", 1 << 14)]
    assert seen == ["ec_fixed_base"] * 2 * (len(smoke.FB_EDGE) + 1)
    assert all(r["loop_launches"] == 32 for r in rows)
    assert all(r["bound_ms"] > 0 and r["ms"] > 0 and r["loop_ms"] > 0 for r in rows)


def test_jacobian_shapes_every_shape_compared(smoke):
    """K8 at every shape of a 2^14 Jacobian prove (`k8_shapes`) against its
    plain version and the one-thread K8, and its chain entry at the window
    folds' shapes against its plain version and the loop of K8 launches
    it replaced, G1 and G2 (`jacobian_shape_checks`); the G2 team splits
    up to 2048 points."""
    import numpy as np

    from ckb_zkp_tpu_torch.host.pairing import get_curve

    seen = []

    def record(name, err, ms, plain_ms, what, work=None, library_ms=None):
        assert err == 0, what
        seen.append(name)

    curve = get_curve("bn254")
    rows = smoke.jacobian_shape_checks(record, np.random.default_rng(5), curve, 14)
    adds, chains = smoke.k8_shapes(14)
    assert [(r["name"], r["group"], r["points"]) for r in rows] == [
        (name, g, n) for g in ("g1", "g2")
        for name, n in [("ec_add", n) for n, _ in adds] + [("ec_add_chain", k)
                                                           for k, _ in chains]]
    assert seen.count("ec_add") == 2 * len(adds)
    assert all(r["bound_ms"] > 0 and r["ms"] > 0 for r in rows)
    assert all(r["lanes"] == (16 if r["group"] == "g2" and r["points"] <= 2048 else 4)
               for r in rows)


def test_k6_device_setup_equals_host_mode(smoke):
    smoke.phase_setup_check(10)


def test_small_setup_and_prove_launch_every_kernel(smoke):
    run = smoke.phase_slice(torch.cuda.get_device_name(0), 13)
    assert run["setup_launches"]["rcb_fixed_base"] > 0
    assert all(run["prove_launches"][k] > 0 for k in RCB_PROVE)


def test_small_jacobian_setup_and_prove_equal_the_rcb_ones(smoke):
    card = torch.cuda.get_device_name(0)
    jac = smoke.phase_jacobian(card, smoke.phase_slice(card, 13), 13)
    assert jac["setup_launches"]["ec_fixed_base"] == 5
    assert jac["setup_launches"]["ec_madd"] == 0
    assert all(jac["prove_launches"][k] > 0 for k in JAC_PROVE)


def test_jacobian_msm_leaf_branch_launches_the_elementwise_k9a(smoke):
    """The G1 and G2 Jacobian MSMs at `leaf_shapes`' width equal the host
    ints and launch the elementwise K9a as often as `leaf_shapes` counts
    (`phase_jacobian_leaf`)."""
    launches = smoke.phase_jacobian_leaf(torch.cuda.get_device_name(0))
    assert launches["ec_madd"] == 2 * smoke.leaf_shapes()[2]
    assert launches["ec_fixed_base"] == 0


def test_probe_kernels_bit_equal_and_launched_by_the_probes(smoke):
    results = {}
    out = smoke.phase_probes(results, 13)
    assert set(results) == smoke.PROBE_KERNELS
    assert all(r["max_abs_err"] == 0 and r["bound_ms"] > 0 for r in results.values())
    assert all(out["launches"][k] > 0 for k in smoke.PROBE_KERNELS)
    assert out["window"]["stages_ms"] and out["scan"]["variants"] and out["mxu"]["variants"]
    assert out["grid"]["variants"] and out["dma"]["variants"]


def test_tensor_core_kernels_bit_equal_at_edge_shapes(smoke):
    """fp_mul_tc through P17 and P18/P19, and P12-P16, against their plain
    versions at partial warps, ragged g-major blocks and all-flagged
    blocks (the probes' own checks)."""
    from ckb_zkp_tpu_torch.probes import mxu, scan

    mxu.check("cuda")
    scan.check("cuda")


def test_grid_and_dma_kernels_bit_equal_at_edge_shapes(smoke):
    """P7-P11 against their plain versions and P-tot's and P-prepk's
    kernels at ragged tiles, partial blocks and all-flagged blocks, and
    P20-P22 against theirs at small shapes (the probes' own checks)."""
    from ckb_zkp_tpu_torch.probes import dma, grid

    grid.check("cuda")
    dma.check("cuda")

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
JAC_PROVE = {"ec_add", "ec_block_totals_madd", "ec_block_totals_add"}
KERNELS = RCB_PROVE | JAC_PROVE | {"rcb_madd", "ec_madd"}


@pytest.fixture
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def test_kernels_bit_equal_to_plain(smoke):
    results = {}
    smoke.phase_kernels(results, 12)
    assert set(results) == KERNELS
    assert all(r["max_abs_err"] == 0 and r["bound_ms"] > 0 for r in results.values())


def test_k6_device_setup_equals_host_mode(smoke):
    smoke.phase_setup_check(10)


def test_small_setup_and_prove_launch_every_kernel(smoke):
    run = smoke.phase_slice(torch.cuda.get_device_name(0), 13)
    assert run["setup_launches"]["rcb_madd"] > 0
    assert all(run["prove_launches"][k] > 0 for k in RCB_PROVE)


def test_small_jacobian_setup_and_prove_equal_the_rcb_ones(smoke):
    card = torch.cuda.get_device_name(0)
    jac = smoke.phase_jacobian(card, smoke.phase_slice(card, 13), 13)
    assert jac["setup_launches"]["ec_madd"] > 0
    assert all(jac["prove_launches"][k] > 0 for k in JAC_PROVE)


def test_probe_kernels_bit_equal_and_launched_by_the_probes(smoke):
    results = {}
    out = smoke.phase_probes(results, 13)
    assert set(results) == smoke.PROBE_KERNELS
    assert all(r["max_abs_err"] == 0 and r["bound_ms"] > 0 for r in results.values())
    assert all(out["launches"][k] > 0 for k in smoke.PROBE_KERNELS)
    assert out["window"]["stages_ms"] and out["scan"]["variants"] and out["mxu"]["variants"]


def test_tensor_core_kernels_bit_equal_at_edge_shapes(smoke):
    """fp_mul_tc through P17 and P18/P19, and P12-P16, against their plain
    versions at partial warps, ragged g-major blocks and all-flagged
    blocks (the probes' own checks)."""
    from ckb_zkp_tpu_torch.probes import mxu, scan

    mxu.check("cuda")
    scan.check("cuda")

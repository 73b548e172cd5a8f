"""Kernel against plain version on the card: chip_smoke.py's phases 3 to 5
at a small size. Marked `cuda`; without a card they skip."""

import os
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = {"mont_mul", "scan_prefix_madd", "scan_prefix_add", "scan_total_add",
           "rcb_add", "rcb_madd"}


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
    setup, prove = smoke.phase_slice(torch.cuda.get_device_name(0), 13)
    assert setup["rcb_madd"] > 0
    assert all(prove[k] > 0 for k in KERNELS - {"rcb_madd"})

"""Kernel against plain version on the card: chip_smoke.py's phases 3 and 4
at a small size. Marked `cuda`; without a card they skip."""

import os
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    assert set(results) == {
        "mont_mul", "scan_prefix_madd", "scan_prefix_add", "scan_total_add", "rcb_add"}
    assert all(r["max_abs_err"] == 0 for r in results.values())


def test_small_prove_verifies_and_launches_every_kernel(smoke):
    launches = smoke.phase_slice(torch.cuda.get_device_name(0), 12)
    assert all(v > 0 for v in launches.values())

"""Kernel against plain version on the card: chip_smoke.py's phases 3 to 8
at a small size, BN254's 8-word kernels and BLS12-381's 12-word K1-K6;
the polynomial layer and a KZG10 commitment against the CPU and host ints,
the Marlin phase at 2^12; the reference PLONK circuit and aSVC's key_gen
at 2^12 on the card against the CPU, and the PLONK and aSVC phases at
2^13; K1 at curve25519's moduli, the Spartan Mini proofs (NIZK and SNARK,
BN254 and curve25519, the device thresholds at 2) on the card against
the CPU, and chip_smoke's Spartan runs at a small size with the thresholds
patched down; the reference tests' Bulletproofs (BN254 and curve25519),
Hyrax and Libra (plain and zk) proofs with the device thresholds at 2 on
the card against the CPU; the CLI's Groth16 Mini on the card against the
CPU. Marked `cuda`; without a card they skip."""

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


def test_jacobian_totals_every_shape_compared(smoke):
    """K9b (leaves in order and through a permutation) and K9c at one
    block, 67 blocks of B = 5, 4229 blocks and the G2 team boundary (2048,
    2049 chains), then at a 2^14 prove's shapes, K9b through a real sort
    order, G1 and G2, bit for bit against their plain versions
    (`jacobian_totals_checks`)."""
    import numpy as np

    from ckb_zkp_tpu_torch.host.pairing import get_curve

    seen = []

    def record(name, err, ms, plain_ms, what, work=None, library_ms=None):
        assert err == 0, what
        seen.append(name)

    rows = smoke.jacobian_totals_checks(record, np.random.default_rng(6), get_curve("bn254"),
                                        14)
    sizes = smoke.path_shapes(14, 256)
    assert [(r["name"], r["group"], r["N"]) for r in rows] == [
        (name, g, sizes[name]) for g in ("g1", "g2")
        for name in ("ec_block_totals_madd", "ec_block_totals_add")]
    n = len(smoke.TOTALS_EDGE) + 1
    assert seen.count("ec_block_totals_madd") == seen.count("ec_block_totals_add") == 2 * n
    assert all(r["bound_ms"] > 0 for r in rows)
    assert all(r["old_ms"] > 0 for r in rows if r["name"] == "ec_block_totals_madd")


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


def test_wide_kernels_bit_equal_to_plain(smoke):
    """BLS12-381's 12-word K1-K6, G1 and G2, bit for bit against their
    plain versions at edge values (K1: 0, 1, p - 1, R; K5: P + P, P - P and
    identities, also against the host group; K2 with flagged leaves, in
    order and through random orders, at the G2 team boundary; K3/K4 at
    ragged chain counts; K6 at 1-2049 points with edge scalars) and at a
    2^14 slice's shapes; the MSM equals the host ints and the Jacobian
    engine refuses 12 words (`phase_wide_kernels`)."""
    results = {}
    smoke.phase_wide_kernels(results, 14)
    assert set(results) == set(smoke.WIDE_ROWS)
    assert all(r["max_abs_err"] == 0 and r["bound_ms"] > 0 for r in results.values())


def test_wide_jacobian_kernels_raise_and_do_not_fall_back():
    """The Jacobian engine's kernels have no 12-word instance: a BLS12-381
    call on the card raises at its launch and computes nothing on the
    plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_ec
    from ckb_zkp_tpu_torch.ops.msm import device_group

    curve = get_curve("bls12_381")
    for group in ("g1", "g2"):
        dg = device_group(curve, group, "cuda")
        P = dg.encode_points([dg.host_group.mul(curve.g1_gen if group == "g1"
                                                else curve.g2_gen, 3)] * 64)
        leaves = (P[0], P[1], dg.cf.is_zero(P[2]))
        calls = (lambda: cuda_ec.ec_add(dg.cf, P, P),
                 lambda: cuda_ec.ec_madd(dg.cf, P, leaves),
                 lambda: cuda_ec.block_totals_madd(dg.cf, leaves, 32),
                 lambda: cuda_ec.block_totals_add(dg.cf, P, 32),
                 lambda: cuda_ec.ec_add_chain(dg.cf, tuple(c[:1] for c in P),
                                              tuple(c[:2].unsqueeze(1) for c in P), [1, 0]))
        for call in calls:
            with pytest.raises(RuntimeError, match="CUDA launch failed"):
                call()


def test_wide_small_setup_and_prove_launch_every_wide_kernel(smoke):
    run = smoke.phase_slice(torch.cuda.get_device_name(0), 13, "bls12_381")
    assert run["setup_wide"]["rcb_fixed_base"] == 5
    assert all(run["prove_wide"][k] > 0 for k in RCB_PROVE)


def test_wide_front_ends_and_bytes(smoke):
    """Mini on BLS12-381 through the front ends, and a 2^10 setup's keys
    through the byte codec: the decoded keys prove the same proof."""
    card = torch.cuda.get_device_name(0)
    smoke.phase_wide_frontends(card)
    smoke.phase_wide_bytes(card, smoke.phase_setup_check(10, "bls12_381"))


def test_poly_layer_on_the_card_equals_the_cpu(smoke):
    """`poly_divide_linear`, `poly_mul` and `HDomain`'s four transforms at
    2^16 on the card (K1) equal their CPU results (K1's plain version)."""
    import random

    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import poly
    from ckb_zkp_tpu_torch.ops.field import device_field
    from ckb_zkp_tpu_torch.ops.hdomain import HDomain

    spec = get_curve("bn254").fr
    rng = random.Random(16)
    n = 1 << 16
    xs = [rng.randrange(spec.modulus) for _ in range(n)]
    z = rng.randrange(spec.modulus)
    out = {}
    for dev in ("cuda", "cpu"):
        df = device_field(spec, dev)
        c = df.encode(xs)
        q, r = poly.poly_divide_linear(df, c, z)
        m = poly.poly_mul(df, c[: n // 2], c[n // 2 :])
        dom = HDomain(spec, n, dev)
        out[dev] = (df.decode(q), df.decode_scalar(r), df.decode(m),
                    *(getattr(dom, f)(xs) for f in ("fft", "ifft", "coset_fft", "coset_ifft")))
    assert out["cuda"] == out["cpu"]


def test_kzg10_commit_equals_the_host_msm(smoke):
    """A KZG10 commitment over 2^17 powers on the card (K1-K6) equals the
    host-int MSM of the same powers and coefficients."""
    import random

    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops.field import device_field
    from ckb_zkp_tpu_torch.ops.msm import device_group
    from ckb_zkp_tpu_torch.schemes import kzg10

    curve = get_curve("bn254")
    n = 1 << 17
    rng = random.Random(17)
    pp = kzg10.setup(curve, n - 1, rng, device="cuda")
    ck, _ = kzg10.trim(pp, n - 1)
    coeffs = [rng.randrange(curve.fr.modulus) for _ in range(n)]
    comm, _ = kzg10.commit(ck, device_field(curve.fr, "cuda").encode(coeffs))
    powers = device_group(curve, "g1", "cuda").decode_points(ck.powers_of_g)
    assert comm == curve.g1.msm(powers, coeffs)


def test_marlin_phase_at_2_12(smoke):
    """chip_smoke's Marlin phase at |H| = 2^12 (the smallest whose MSMs
    launch K3), the Mini proof on the card against the CPU one, and the
    BLS12-381 KZG10 round trip at degree 2^12."""
    card = torch.cuda.get_device_name(0)
    child = smoke.start_mini_cpu()
    try:
        run = smoke.phase_marlin(card, 12)
        smoke.phase_marlin_mini(card, child)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert all(v > 0 for v in run["launches"].values())
    assert run["division"]["k1_launches"] == run["division"]["rounds"]
    assert all(v > 0 for v in smoke.phase_kzg_wide(card, 12).values())


def test_plonk_reference_circuit_on_the_card_equals_the_cpu(smoke):
    """`tests/test_plonk.py`'s circuit over BLS12-381 (SRS 64): the vk and
    proof bytes on the card (K1-K6) equal the CPU's (their plain versions)."""
    assert smoke.plonk_reference_proof("cuda") == smoke.plonk_reference_proof("cpu")


def test_asvc_key_gen_on_the_card_equals_the_cpu(smoke):
    """aSVC's key_gen at n = 2^12 over BLS12-381 on the card (the 12-word
    fixed-base K6 on G1 and G2, K1) equals the CPU's, the G2 powers
    included."""
    import random

    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.schemes import asvc

    curve = get_curve("bls12_381")
    card, cpu = (asvc.key_gen(curve, 1 << 12, random.Random(12), device=d)
                 for d in ("cuda", "cpu"))
    for name in ("powers_of_g1", "l_of_g1"):
        got, want = getattr(card.proving_key, name), getattr(cpu.proving_key, name)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want)), name
    assert card.proving_key.update_keys == cpu.proving_key.update_keys
    assert card.verification_key.powers_of_g2 == cpu.verification_key.powers_of_g2
    assert len(card.verification_key.powers_of_g2) == (1 << 12) + 1
    assert (card.verification_key.a, card.n, card.omega) == (
        cpu.verification_key.a, cpu.n, cpu.omega)


def test_plonk_and_asvc_phases_at_2_13(smoke):
    """chip_smoke's PLONK phase at n = 2^13 gates and its aSVC phase at
    2^13 positions (the smallest whose MSMs launch K3: more than 128
    block totals a window): every verdict, and every kernel of each phase
    launched."""
    card = torch.cuda.get_device_name(0)
    run = smoke.phase_plonk(card, 13)
    assert all(v > 0 for v in run["launches"].values())
    wide = smoke.phase_asvc(card, 13)
    assert all(v > 0 for v in wide["wide"].values()) and wide["fr_mont_mul"] > 0


def test_k1_at_curve25519_moduli_bit_equal(smoke):
    """K1 at 2^255 - 19 and at l against its plain version, edge rows
    included (`phase_spartan_kernels` at 2^12 rows)."""
    results = {}
    smoke.phase_spartan_kernels(results, 1 << 12)
    assert set(results) == {"mont_mul_25519_fq", "mont_mul_25519_fr"}
    assert all(r["max_abs_err"] == 0 and r["bound_ms"] > 0 for r in results.values())


def test_spartan_mini_proofs_on_the_card_equal_the_cpu(smoke):
    """The Mini NIZK and SNARK proofs on BN254 and curve25519 with
    FIXED_BASE_MSM_MIN and DEVICE_SUMCHECK_MIN at 2 (every commitment of
    two or more scalars on the RCB engine or the Ristretto group, every
    sumcheck on device tables): the card's bytes equal the CPU's (the
    plain versions; some minutes of CPU)."""
    assert smoke.spartan_mini_proofs("cuda") == smoke.spartan_mini_proofs("cpu")


def test_spartan_runs_small_with_the_device_paths_patched_on(smoke, monkeypatch):
    """chip_smoke's Spartan runs at 2^6 constraints (SNARK 2^3), with
    FIXED_BASE_MSM_MIN at 8 and DEVICE_SUMCHECK_MIN at 16 so that the
    witness commitment's rows, the generators and the sumchecks run on the
    card: every verdict, bytes round trip and contract code, device calls
    of both kinds, K1, K2 and K5 on BN254 and K1 at both curve25519
    fields."""
    from ckb_zkp_tpu_torch.ops import msm, sumcheck

    monkeypatch.setattr(msm, "FIXED_BASE_MSM_MIN", 8)
    monkeypatch.setattr(sumcheck, "DEVICE_SUMCHECK_MIN", 16)
    card = torch.cuda.get_device_name(0)
    for label, curve, kind, log_c, contract in (
            ("a", "bn254", "nizk", 6, True), ("b", "curve25519", "nizk", 6, False),
            ("c", "bn254", "snark", 3, True)):
        run = smoke.spartan_run(card, label, curve, kind, log_c, contract,
                                profile=label == "a")
        assert run["counts"]["msm_device"] > 0 and run["counts"]["sumcheck_device"] > 0
        if curve == "bn254":
            assert run["counts"]["generators_device"] > 0
            assert all(run["launches"][k] > 0 for k in ("mont_mul", "scan_prefix_madd",
                                                         "rcb_add"))
        else:
            assert run["k1"]["curve25519_fq"] > 0 and run["k1"]["curve25519_fr"] > 0


@pytest.mark.parametrize("scheme", ["bulletproofs", "hyrax", "libra"])
def test_dl_mini_proofs_on_the_card_equal_the_cpu(smoke, scheme):
    """The reference tests' proofs of `scheme` (Bulletproofs' Mini on BN254
    and curve25519, Hyrax's 4 instances, Libra's reference circuit plain
    and zk) with FIXED_BASE_MSM_MIN and DEVICE_SUMCHECK_MIN at 2: the
    card's proofs verify, refuse a changed input or output, and their
    bytes equal the CPU's (the plain versions; minutes of CPU)."""
    assert smoke.dl_mini_proofs("cuda", (scheme,)) == smoke.dl_mini_proofs("cpu", (scheme,))


def test_cli_groth16_mini_on_the_card_equals_the_cpu(smoke):
    """The CLI's Groth16 Mini over BN254 through `main(argv)` on the card
    and with `--device cpu` (setup seed 5, prove seed 6, verify, a changed
    public input refused): the card's setup files and proof JSON equal the
    CPU's byte for byte, and its setup and prove launch their kernels."""
    labels = ["groth16-bn254-mini"]
    card, cpu = smoke.cli_runs("cuda", labels), smoke.cli_runs("cpu", labels)
    assert card["files"] == cpu["files"] and len(card["files"]) == 4
    for cmd, need in smoke.CLI_NEEDS["groth16-bn254-mini"].items():
        assert all(card["launches"][f"groth16-bn254-mini {cmd}"].get(k, 0) > 0 for k in need)


def test_parallel_phase_on_the_card(smoke):
    """The sharded prove on the card at 2^14 (`phase_parallel`): (p1) one
    rank over NCCL and (p2) two ranks sharing the card over gloo, each
    proof equal to the slice's single-device proof, K1, K2, K4 and K5
    launched by every rank; (p3) BLS12-381 G1 and G2 msm_sharded against
    the host ints, the fold on the 12-word K5."""
    run = smoke.phase_slice(smoke.smi(), 14)
    par = smoke.phase_parallel(smoke.smi(), run, 14)
    assert len(par["p2"]) == smoke.PARALLEL_RANKS
    for rec in [par["p1"], *par["p2"]]:
        assert all(rec["launches"].get(k, 0) > 0 for k in smoke.PARALLEL_NEEDS)
    assert all(g["fold_rcb_add_nw12"] > 0 for g in par["p3"].values())

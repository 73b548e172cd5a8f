#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's Groth16 setup and prover on one GPU, on BN254
and on BLS12-381.

    python3 chip_smoke.py              # phases at 2^20 (probes 2^21); needs one CUDA card
    python3 chip_smoke.py --log2 14    # the same at a 2^14 slice

Phases: (1) the card, its power limit, SM clock and the torch/CUDA
versions; (2) nvcc builds the kernels from ckb_zkp_tpu_torch/csrc, one
process per source, in parallel; (3) every kernel of the setup's and the
prover's paths (K1-K6) against its plain PyTorch version on the same CUDA
tensors, bit-exact, with both times: at small shapes with edge values, then
at the shapes the slice gives each kernel (K6's fixed-base kernel at 1, 7,
2047, 2048 and 2049 points with edge scalars, then at the setup's width,
where it must also equal the per-window loop it replaced, `fixed_base_checks`,
each width row with its registers and the loop's ms; the elementwise K6 at
its edge values and at the loop's width; K1: the prove's; K2 at the
prove's shape through a real sort order
and K5 at every shape of the prove, `k5_shapes`, after the edge shapes and
the G2 team boundary, `team_checks`, each with its event and device ms,
team lanes, threads and bound; K3 and K4 at every (M, B) of one
window batch of the prove, `scan_levels`, after edge and ragged chain
counts, with each level's ms, threads and bound), each beside its
bound; the Jacobian
engine's K8, K9a, K9b and K9c the same way (edge cases P = Q, P = -Q,
identity on each side and flagged leaves against the host group, then the
shapes of its 2^log2 setup and prove: K9a's fixed-base kernel at the edge
point counts with edge scalars and at the setup's width, where it must also
equal the per-window loop it replaced after normalization,
`jacobian_fixed_base_checks`; K8 at every shape of the prove, `k8_shapes`,
held against the one-thread K8 too, and its chain entry at the window
folds' shapes against the loop of K8 launches it replaced,
`jacobian_shape_checks`; K9b with the leaves in order and through a
permutation, and K9c, at one block, 67 blocks of B = 5,
4229 blocks and the G2 team boundary of 2048 and 2049 chains with
flagged leaves, P == Q and P == -Q inside a block, then at the prove's
shapes, K9b through a real sort order, each beside its bound and its old
time, `jacobian_totals_checks`); and the port's MSM on both engines
against the host-int MSM on a small input; (4) a 2^14 setup check: the
device instance map against the host ints, and the device-branch queries
against the host-mode queries point for point; (5) the slice: the device
setup of a (2^log2 - 2)-constraint square chain with its stage times, one
warm-up and one timed prove, the verifier's verdict on the proof and on a
tampered public input, the kernel launch counts of the setup (K6's
fixed-base kernel once a query, 5 times, and the elementwise K6 never) and
of the timed prove (K1-K5; every K2 launch through a sort order), and a check
that the timed prove leaves no device memory behind; (6) the same setup and prove on the Jacobian MSM engine
(`_use_rcb = False` on the two cached device groups, restored after):
every query equal to the RCB setup's limb for limb on the rows both hold
(the others at infinity), the proof equal to the RCB proof for the same
(r, s), the verifier's verdicts, K9a's fixed-base kernel launched by that
setup once a query (5 times) and the elementwise K9a never, and K8, its
chain, K9b and K9c by that prove, K8 and the chain no more often than
`k8_shapes` counts, K9b (every launch through the sort order) and K9c
once a window batch, and, in a prove of the 2^15 square chain (the
smallest whose MSMs read their leaves through the order) traced with
stacks, no row read that an `aten::index` op launched from `_window_sums`
(the sorted copy of the leaves made three a window batch); then a G1 and a G2
Jacobian MSM of 2^14 points, the
widest that still runs the elementwise K9a (`_prefix_boundary_leaf`'s
leaf branch, `leaf_shapes`), against the host ints, with that K9a's
launches counted from those two MSMs alone (`phase_jacobian_leaf`);
the sharded prove (`phase_parallel`, `ckb_zkp_tpu_torch/parallel/`): (p1)
one rank over NCCL in this process proves the 2^log2 chain with `mesh=`
(the sharded domain at d = 1, the sharded MSMs), equal point for point to
the slice's proof, with its stages, collective seconds, peak memory and
launches (K1, K2, K4 and K5 required; K3 logged); (p3) on that rank a
BLS12-381 G1 and G2 `msm_sharded` of 2^16 points against the host ints,
its 12-word launches covering the single-device MSM's, and the fold of two
partials on the 12-word K5 (K8 has no 12-word instance); (p2) two ranks in
child processes sharing the one card over gloo (NCCL refuses two ranks on
one device; the collectives pass through host memory), each with its own
synthesis and setup from the same toxic waste, each proof equal to the
slice's, rank 0's verdicts checked, each rank launching K1, K2, K4 and K5.
Several cards (NCCL, a card a rank) are not run: the script needs one;
then BLS12-381 (7), which times its 12-word kernel rows before any child
process shares the card; from there on the Spartan runs, then the DL
runs and the CLI's card work run in child processes beside this one's
phases (host-bound work: the card is mostly idle), each read where its
phase stands below; Marlin (`phase_marlin`): `universal_setup` (2^17 + 1 powers: K6 twice),
`index`, `create_random_proof` and `verify_proof` of the (2^15 -
2)-constraint square chain over BN254, each stage timed (the AHP's device
transforms apart from its host work, `TransformClock`), the proof
verified and refused under a changed public input, every K1-K6 launched
by the phase (`marlin_launches` in the kernel line) and the largest
opening's synthetic division in O(log n) launches; the Mini proof on the
card equal to the port's CPU proof from the plain versions (a child
process started after the timed kernel rows, `phase_marlin_mini`); a KZG10 round
trip over BLS12-381 at degree 2^12 that launches every 12-word K1-K6
(`kzg_launches` in the `_nw12` rows, `phase_kzg_wide`);
PLONK (`phase_plonk`): `Plonk.setup` (4n + 1 powers: K6 twice), `keygen`
(the index, its transforms apart, `TransformClock`; its 11 commitments) and
`prove` of a 2^15-gate square chain through the composer over BN254 with
one public input, each stage timed (the host rounds, the `HDomain`
transforms, the three commitments, the evaluations, the batch opening),
`verify` on the public inputs and on a changed one, the vk and proof
through their ark-0.2 bytes and back unchanged, the contract verifier's OK
and ERR_VERIFY on those cells, every K1-K6 launched (`plonk_launches` in
the kernel line's K1-K6 rows) and a warm prove under the profiler; the
reference circuit of `tests/test_plonk.py` (BLS12-381, SRS 64) on the card
with the CPU child's vk and proof bytes (`phase_plonk_reference`); aSVC
(`phase_asvc`) over BLS12-381 at 2^19 positions: `key_gen` (five
fixed-base MSMs on the card, G2's among them; its host tables and decodes
timed apart) under the profiler, `commit` of 2^19 values, `prove_pos` and
`verify_pos` at one and at 16 positions, `verify_upk`, `update_commit` +
`update_proof` at the same position and another, `aggregate_proofs` of two
proofs, each verdict as `tests/test_asvc.py` expects and wrong values
refused, the 12-word K1-K6 and Fr's K1 launched (`asvc_launches` in the
`_nw12` rows and the K1 row); Spartan (`phase_spartan`, read after aSVC,
when the CPU child of its Mini proofs is done; after K1 at curve25519's
two fields against its plain version at 2^20 rows,
`phase_spartan_kernels`): the runs of SPARTAN_RUNS, square chains whose
witness count equals their constraint count, in child processes beside
each other, started after the BLS12-381 phase (`start_spartan_runs`):
(a) a BN254 NIZK of 2^19 constraints, its prove under the profiler,
verified through its contract verifier (OK, ERR_VERIFY on a changed
public input), whose witness commitment's 512 row MSMs run on the RCB
engine (K1, K2, K5 required), (b) a curve25519 NIZK of 2^19 on the
Ristretto group (K1 at 2^255 - 19 and at l required) and (c) a BN254
SNARK of 2^16 constraints (contract verifier too; its generators one
fixed-base MSM on the card), each with its setup, hash, prove and
verify seconds and stages, its device and host calls of
`msm_over_fixed_base` and of the sumchecks as the launches show them
(`device_calls_counted`: a run with no device call of either fails), the proof
and vk bytes round trip, and the Mini NIZK and SNARK proofs on both curves
with both thresholds at 2 in a child on the card against a CPU child's
bytes (`spartan_launches` in the
K1-K5 rows, two K1 rows for curve25519's fields); Bulletproofs, Hyrax and
Libra (`phase_dl`, after Spartan): the runs of DL_RUNS, (g) Libra over
BLS12-381 on 2^16 copies of the test circuit side by side (2^19 inputs and
witnesses) in this process, its zk prove under the profiler, then
its bytes and its contract verifier's OK and ERR_VERIFY, beside (d)
Bulletproofs over BN254 and (e) over curve25519 on the 2^11 square chain
(BN254's verdicts through the contract verifier on the (Generators,
R1csCircuit, Proof) cell), (f) Hyrax over BLS12-381 on 2^16 instances (its
contract verifier) and (g)'s plain prove and verdicts in child processes
started beside the Spartan phase (`start_dl_runs`), each with
its setup, prove and verify seconds and stages, its bytes round trip, its
device and host calls (`device_calls_counted`: a device MSM in each, a
device sumcheck in (f) and (g)), K1 by field and the K1-K6 launches (the
12-word ones apart), which must include K1, K2, K5 and K6 in (d), K1 at
2^255 - 19 in (e), the 12-word K2, K5 and K6 and Fr's K1 in (f) and (g);
the Mini proofs of the reference tests with both thresholds at 2 on the
card against a CPU child's bytes (`dl_launches` in the K1-K6, the
`_nw12` and the `mont_mul_25519_fq` rows); the CLI (`phase_cli`, after
`phase_dl`; its card work in a child process started beside (g),
`cli_card`): `python3 -m ckb_zkp_tpu_torch.cli.main` setup, prove and
verify of Groth16 BN254 hash, each a process, exit codes 0, 0, 0 and 1
for a changed public input (`cli_chain`, in a thread), beside
`cli_runs` and `cbmt_run`: `main(argv)` round trips of CLI_CASES (tests/test_cli.py's
cases, tests/test_jubjub.py's Edwards case, Groth16 over BLS12-381), each
verified and refused after a changed public input, each command timed and
its launches counted (the pairing schemes' kernels required, CLI_NEEDS;
`cli_launches` in every row), every setup file and proof JSON equal to a
CPU child's (`start_cli_cpu`, started after the timed kernel rows) for the
same seeds; the native C++ verifiers on the CLI's Groth16 and Marlin
cells (0, 2, 1, as the contract verifiers); and Groth16 over BN254 of a
SHA-256 CBMT membership circuit (5 lemmas, a 32-leaf tree, `cbmt_run`,
after `cli_runs`), verified and refused with a flipped root bit, its
setup launching K6 and its prove K1-K5; (7)
BLS12-381 (`phase_wide`, after the sharded prove), whose Fq and Fq2 run the 12-word instances of
K1-K6 (its Fr the 8-word ones): each 12-word instance against its plain
version at edge values and at the shapes of a 2^log2 BLS12-381 setup and
prove, G1 and G2 (`phase_wide_kernels`: K1 at 0, 1, p - 1 and R and at the
setup's normalization width, K5 at P + P, P - P and identities also
against the host group, then `fixed_base_checks` with the plain version
on the first WIDE_FB_PLAIN_ROWS points at the setup's width, `team_checks`
and `scan_level_checks`), the port's MSM against the host ints and the
Jacobian engine's refusal at 12 words (it has no 12-word kernel: a launch
raises); the 2^12 setup check; the 2^log2 slice (setup, proves, verdicts,
memory), which must launch the 12-word K6 5 times and every 12-word K1-K5
(`cuda_build.WIDE`); the front ends on Mini (random and no-zk proofs
verify, a wrong public input is refused); and the 2^12 setup check's keys
through the key, proof and vk bytes, the decoded keys proving the same
proof; (8) the probes (`ckb_zkp_tpu_torch/probes/`): K2a and K2b (G1, G2) and the
scan probes' kernels P-tot, P-prepk and P-chain (G1, every K and block
size) against their plain versions at edge shapes (the probes' own checks) and at 2^(log2 + 1); the g-major P-tot and
P-prepk (P12, P13) and P-tot on the tensor-core Montgomery reduction
(P18 g-major, P19), at every block size, at edge shapes and at
2^(log2 + 1), P18 and P19 also against P-tot's kernel; the mxu probe's
kernels (P14 u32 op chains, P15 int8 band matmuls, P16 and P17 multiply
chains, CIOS and tensor-core, P17 also against P16) at edge shapes and at
their full sizes; the grid probe's P7 and P8 (P-tot and P-prepk with the
leaves staged through shared memory, 64 and 256 threads), P11 (P8 with a
W tile flushed once, 32 and 64 columns), P9 and P10 (W written with no
arithmetic, per step or per tile) and the dma probe's P20-P22 (a ^ b
under three blockings) at edge shapes and at 2^(log2 + 1), P7 also
against P-tot's kernel and P8 and P11 against P-prepk's; then the window,
scan, mxu, grid and dma probes, which must launch all twenty-one of the
phase's kernels (34 kernels in the table in all: K6, K8 and K9a have two
entries each).

Bounds: the least time the card could take for a kernel's work at that
shape, the larger of its bytes (each input read once, each output written
once; an Fq element is 16 int32 limbs, 64 B, and 24 at BLS12-381, 96 B)
over 3.35 TB/s and its 32-bit multiply instructions (an NW-word CIOS
product is 2 NW^2 + NW word products, each a low and a high IMAD: 272
IMADs at 8 words, 600 at 12; Fq2 is 3 Fq products) over 64 IMAD
per SM per clock at the SM's maximum clock, counting the multiplies this
run's data needs (a flagged leaf or an add to infinity needs none), and
int8 tensor-core operations over 1,979 TOPS (P15; the tensor-core
multiply's reduction, whose product counts 2 * 8^2 IMADs); P14's steps
at one op each, at the same 64 per SM per clock. No single PyTorch call computes most of
these functions, so `library_ms` is null, except for P15 (one
`torch._int_mm` of its matmul step over the whole batch), P9 and P10 (two
`copy_` and one `torch.bitwise_xor`, timed together) and P20-P22 (one
`torch.bitwise_xor(a, b, out=o)`): yardsticks the port never calls.

The last line is {"ok": true, "device": {...}}; before it come the card's
name and power limit and one JSON line with the kernel table (a row for
each 8-word kernel and one, named "<kernel>_nw12", for each 12-word
instance of K1-K6, its launches from the BLS12-381 slice, with
`parallel_launches` from (p1) in the K1-K6 rows and from (p3) in the
12-word rows; K1 at
curve25519's fields as "mont_mul_25519_fq" and "mont_mul_25519_fr", their
launches from the Spartan run (b)). Without a
CUDA device, or without the rest of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
from ckb_zkp_tpu_torch.probes.common import (  # noqa: E402
    FQ_BYTES, IMAD_PER_FQ_MUL, bound, cuda_ms, fq_bytes, fq_muls, imad_per_mul, imad_rate,
    max_abs_err, rand_field, smi)
from ckb_zkp_tpu_torch.probes.levels import device_ms  # noqa: E402

SEED = 20261016
DEVICE = "cuda"
CSRC = "ckb_zkp_tpu_torch/csrc/"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "mont_mul": ("mont_mul.cu", "ckb_zkp_tpu/ops/pallas_field.py:323"),
    "scan_prefix_madd": ("rcb_team.cuh", "ckb_zkp_tpu/ops/pallas_rcb.py:248"),
    "scan_prefix_add": ("rcb_team.cuh", "ckb_zkp_tpu/ops/pallas_rcb.py:297"),
    "scan_total_add": ("rcb_team.cuh", "ckb_zkp_tpu/ops/pallas_rcb.py:316"),
    "rcb_add": ("rcb_team.cuh", "ckb_zkp_tpu/ops/pallas_rcb.py:193"),
    "rcb_madd": ("rcb_madd.cu", "ckb_zkp_tpu/ops/pallas_rcb.py:204"),
    "rcb_fixed_base": ("rcb_fixed_base.cu", "ckb_zkp_tpu/ops/pallas_rcb.py:204"),
    "ec_add": ("ec_team.cuh", "ckb_zkp_tpu/ops/pallas_ec.py:247"),
    "ec_add_chain": ("ec_team.cuh", "ckb_zkp_tpu/ops/pallas_ec.py:247"),
    "ec_madd": ("ec_madd.cu", "ckb_zkp_tpu/ops/pallas_ec.py:259"),
    "ec_fixed_base": ("ec_fixed_base.cu", "ckb_zkp_tpu/ops/pallas_ec.py:259"),
    "ec_block_totals_madd": ("ec_scan.cu", "ckb_zkp_tpu/ops/pallas_ec.py:271"),
    "ec_block_totals_add": ("ec_team.cuh", "ckb_zkp_tpu/ops/pallas_ec.py:290"),
    "scan_prefix_madd_unpacked": ("rcb_scan.cu", "ckb_zkp_tpu/ops/pallas_rcb.py:275"),
    "scan_prefix_madd_packed": ("rcb_scan.cu", "ckb_zkp_tpu/ops/pallas_rcb.py:225"),
    "probe_madd_totals": ("probe_scan.cu", "scripts/probe_scan.py:95"),
    "probe_madd_prefix_packed": ("probe_scan.cu", "scripts/probe_scan2.py:181"),
    "probe_chain_mul": ("probe_scan.cu", "scripts/probe_scan2.py:94"),
    "probe_gmajor_totals": ("probe_scan.cu", "scripts/probe_scan5.py:134"),
    "probe_gmajor_prefix": ("probe_scan.cu", "scripts/probe_scan5.py:205"),
    "probe_u32_ops": ("probe_mxu.cu", "scripts/probe_mxu.py:77"),
    "probe_band_mma": ("probe_mxu.cu", "scripts/probe_mxu.py:121"),
    "probe_mul_chain_cios": ("probe_mxu.cu", "scripts/probe_mxu2.py:95"),
    "probe_mul_chain_tc": ("probe_mxu.cu", "scripts/probe_mxu2.py:110"),
    "probe_gmajor_totals_tc": ("probe_scan.cu", "scripts/probe_scan6.py:160"),
    "probe_madd_totals_tc": ("probe_scan.cu", "scripts/probe_scan7.py:177"),
    "probe_grid_totals": ("probe_grid.cu", "scripts/probe_scan3.py:132"),
    "probe_grid_prefix": ("probe_grid.cu", "scripts/probe_scan3.py:199"),
    "probe_wo_steps": ("probe_grid.cu", "scripts/probe_scan4.py:100"),
    "probe_wo_tile": ("probe_grid.cu", "scripts/probe_scan4.py:128"),
    "probe_grid_prefix_tile": ("probe_grid.cu", "scripts/probe_scan4.py:195"),
    "probe_xor_flat": ("probe_dma.cu", "scripts/probe_dma.py:60"),
    "probe_xor_lead1": ("probe_dma.cu", "scripts/probe_dma.py:74"),
    "probe_xor_grid2d": ("probe_dma.cu", "scripts/probe_dma.py:88"),
}
# the run whose launches each kernel's row reports
SETUP_KERNELS = {"rcb_fixed_base"}  # the RCB setup
# the per-window loop that the RCB setup's fixed-base kernel replaced
# (digits, gathers, the elementwise K6 a window), run by `fixed_base_checks`
LOOP_KERNELS = {"rcb_madd"}
JAC_SETUP_KERNELS = {"ec_fixed_base"}  # the Jacobian engine's setup
# the Jacobian MSM below 2^15 points (`_prefix_boundary_leaf`'s leaf
# branch, `leaf_shapes`), run by `phase_jacobian_leaf`
JAC_LEAF_KERNELS = {"ec_madd"}
JAC_PROVE_KERNELS = {"ec_add", "ec_add_chain", "ec_block_totals_madd",
                     "ec_block_totals_add"}
PROBE_KERNELS = {"scan_prefix_madd_unpacked", "scan_prefix_madd_packed", "probe_madd_totals",
                 "probe_madd_prefix_packed", "probe_chain_mul", "probe_gmajor_totals",
                 "probe_gmajor_prefix", "probe_u32_ops", "probe_band_mma",
                 "probe_mul_chain_cios", "probe_mul_chain_tc", "probe_gmajor_totals_tc",
                 "probe_madd_totals_tc", "probe_grid_totals", "probe_grid_prefix",
                 "probe_wo_steps", "probe_wo_tile", "probe_grid_prefix_tile", "probe_xor_flat",
                 "probe_xor_lead1", "probe_xor_grid2d"}  # the probes' runs

def log(msg: str) -> None:
    print(msg, flush=True)


def timed_once(fn):
    """(fn(), milliseconds of that one call by CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def chunked_plain(fn, rg, *operands, chunk: int = 1 << 16):
    """An elementwise plain version in chunks of points, to bound its int64
    and float64 temporaries; the function is elementwise, so the values are
    the same as one call's. Each operand is a tuple of tensors."""
    import torch

    n = operands[0][0].shape[0]
    parts = [fn(rg, *(tuple(c[i : i + chunk] for c in op) for op in operands))
             for i in range(0, n, chunk)]
    return tuple(torch.cat(cs, dim=0) for cs in zip(*parts))


def path_shapes(log2: int, scalar_bits: int) -> dict:
    """Element counts each kernel gets from the 2^log2 square-chain slice,
    derived from the code's own rules. The prove (`ops/msm.py`): every MSM
    has npad = 2^log2 points and runs `batch` windows of nb buckets per
    launch; K2 scans batch * npad sorted leaves; K5 (E = before + W[q])
    runs at batch * nb; K1 multiplies 2^log2 witness rows (K3 and K4's
    levels: `scan_levels`). The setup: K6's fixed-base kernel runs once
    a query at the fixed-base width, 2^log2 for G1 and G2 (the per-window
    loop it replaced ran the elementwise K6, `rcb_madd`, once a window at
    that width).
    The Jacobian engine (8-bit windows, `jb` of them per batch): K9b sums
    jb * npad sorted leaves, K9c their jb * npad / 32 block totals, K8's
    widest launches are the within-block prefixes of jb * nb queries of 32
    rows each (every K8 shape: `k8_shapes`), and K9a's fixed-base kernel
    runs once a query at npad. The elementwise K9a, `ec_madd`, runs in the
    Jacobian MSM below 2^15 points, at `leaf_shapes`' width."""
    from ckb_zkp_tpu_torch.ops import msm

    npad = 1 << log2
    c = msm.DeviceCurveGroup._msm_window_bits(npad)
    nwin = scalar_bits // c
    batch = max(1, min(nwin, msm._WINDOW_BATCH_POINTS // npad))
    nb = 1 << c
    jb = max(1, min(scalar_bits // msm._FIXED_BASE_BITS, msm._WINDOW_BATCH_POINTS // npad))
    jnb = 1 << msm._FIXED_BASE_BITS
    return {"mont_mul": npad, "scan_prefix_madd": batch * npad,
            "rcb_add": batch * nb, "rcb_madd": npad, "rcb_fixed_base": npad,
            "ec_add": jb * jnb * msm._SCAN_B, "ec_madd": leaf_shapes()[1],
            "ec_fixed_base": npad,
            "ec_block_totals_madd": jb * npad,
            "ec_block_totals_add": jb * npad // msm._SCAN_B}


def leaf_shapes(scalar_bits: int = 256) -> tuple[int, int, int]:
    """The widest Jacobian MSM that runs the elementwise K9a (`ec_madd`),
    from `ops/msm.py`'s own constants: (points, elements a launch,
    launches a MSM). `_prefix_boundary_leaf` takes the leaf branch where
    the point count (a power of two) is not a multiple of _SCAN_B *
    _LEAF_GROUPS (2^15); above `prefix_at_indices`' Hillis-Steele width
    (1024 leaves) that branch sums each block of _SCAN_B leaves with
    _SCAN_B K9a launches over the window batch's k rows of n / _SCAN_B
    blocks. At 2^14 points: one batch of 32 windows, 32 launches of 16384
    elements."""
    from ckb_zkp_tpu_torch.ops import msm

    B = msm._SCAN_B
    n = B * msm._LEAF_GROUPS // 2
    nwin = scalar_bits // msm._FIXED_BASE_BITS
    k = max(1, min(nwin, msm._WINDOW_BATCH_POINTS // n))
    return n, k * (n // B), B * -(-nwin // k)


def scan_levels(log2: int, scalar_bits: int = 256, batch: int | None = None) -> list:
    """(kernel, M, B) of each K3 and K4 launch of one window batch of a
    2^log2-point RCB MSM, in the order `ops/msm.py` makes them, from its own
    constants: `_boundary_before` scans the batch's k rows of npad / _RCB_B
    block totals with K3 while a row holds more than _TOP_MAX points, each
    row padded to a multiple of B; `_reduce_pts` sums the k rows of nb - 1
    bucket prefixes with K4 while a row holds more than _SMALL_SCAN_MAX,
    then once with B = what is left (no launch if one point is). `batch`:
    the windows of the batch (default: a full batch). At 2^20: K3 (65536,
    32), (2048, 32); K4 (131072, 32), (4096, 32), (128, 32), (4, 2)."""
    from ckb_zkp_tpu_torch.ops import msm

    npad = 1 << log2
    c = msm.DeviceCurveGroup._msm_window_bits(npad)
    k = batch or max(1, min(scalar_bits // c, msm._WINDOW_BATCH_POINTS // npad))
    B = msm._RCB_B
    out = []
    n = -(-npad // B)
    while n > msm._TOP_MAX:
        out.append(("scan_prefix_add", k * -(-n // B) * B, B))
        n = -(-n // B)
    n = (1 << c) - 1
    while n > msm._SMALL_SCAN_MAX:
        out.append(("scan_total_add", k * -(-n // B) * B, B))
        n = -(-n // B)
    if n > 1:
        out.append(("scan_total_add", k * n, n))
    return out


def k5_shapes(log2: int, scalar_bits: int = 256) -> list:
    """(points, launches a MSM) of each K5 shape of a 2^log2-point RCB MSM,
    widest first, from `ops/msm.py`'s own constants. Per window batch of k
    windows: `_boundary_before` adds at k * nb points once a K3 level after
    the first and once for the Hillis-Steele top (no add without a K3
    level), and `_bucket_prefixes` once more; the top's scan adds
    ceil(log2 n_top) times at k * n_top points; `_weigh_buckets` adds c + 2
    times at k points (`_scale_pow2_minus1`'s c doublings and its negated
    point, then the sum). The window fold adds nwin * (c + 1) times at one
    point. At 2^20 (8 batches of 2 windows): (131072, 24), (64, 40),
    (2, 144), (1, 272)."""
    from ckb_zkp_tpu_torch.ops import msm

    npad = 1 << log2
    c = msm.DeviceCurveGroup._msm_window_bits(npad)
    nwin = scalar_bits // c
    batch = max(1, min(nwin, msm._WINDOW_BATCH_POINTS // npad))
    nb = 1 << c
    counts: dict = {}

    def add(n, times):
        if times:
            counts[n] = counts.get(n, 0) + times

    for w0 in range(0, nwin, batch):
        k = min(batch, nwin - w0)
        n, levels = -(-npad // msm._RCB_B), 0
        while n > msm._TOP_MAX:
            n, levels = -(-n // msm._RCB_B), levels + 1
        add(k * nb, levels + 1)
        add(k * n, (n - 1).bit_length())
        add(k, c + 2)
    add(1, nwin * (c + 1))
    return sorted(counts.items(), key=lambda kv: -kv[0])


def k8_shapes(log2: int, scalar_bits: int = 256) -> tuple[list, list]:
    """K8's launches in one MSM of the 2^log2 Jacobian prove, from
    `ops/msm.py`'s own constants (the tiling thresholds scaled as
    `jacobian_engine` scales them below 2^20): ([(points, launches)] of the
    elementwise add, widest first; [(points, launches)] of the chain). Per
    window batch of k windows, `_prefix_boundary_leaf` runs K9b, then
    `_combine_blocks`: the prefix of the block totals (`_prefix_boundary_jac`:
    a Hillis-Steele scan of ceil(log2 G) adds at k * G points where G <=
    _JAC_TOP, else a K9c level and the same combine one level up), the
    within-block rows (a Hillis-Steele scan over 32 rows, 5 adds at k * nb
    * 32 points) and one add at k * nb; `_sum_dim1` halves the nb - 1
    bucket prefixes (one add at k * ceil(w / 2) a halving); then one chain
    at k points (`_window_sums`), and one chain at one point a MSM (the
    fold). At 2^20 (16 batches of 2 windows): adds (16384, 160), (2048,
    160), (512, 32), (256, 16), (128, 16) ... (2, 16); chains (2, 16), (1,
    1)."""
    from ckb_zkp_tpu_torch.ops import msm

    npad = max(8, 1 << log2)
    shift = max(0, 20 - log2)
    lg = max(1, msm._LEAF_GROUPS >> shift)
    top = max(1, msm._JAC_TOP >> shift)
    B, c = msm._SCAN_B, msm._FIXED_BASE_BITS
    nwin, nb = scalar_bits // c, 1 << c
    batch = max(1, min(nwin, msm._WINDOW_BATCH_POINTS // npad))
    adds: dict = {}
    chains: dict = {}

    def add(d, n, times):
        if times:
            d[n] = d.get(n, 0) + times

    def combine(k, G):  # _combine_blocks over k rows of G block totals
        if G <= top:
            add(adds, k * G, (G - 1).bit_length())
        else:
            combine(k, -(-G // (B * lg)) * lg)
            add(adds, k * nb * B, (B - 1).bit_length())
            add(adds, k * nb, 1)

    if npad % (B * lg):
        raise ValueError(f"k8_shapes: {npad} leaves take the leaf branch, not K9b")
    for w0 in range(0, nwin, batch):
        k = min(batch, nwin - w0)
        combine(k, npad // B)
        add(adds, k * nb * B, (B - 1).bit_length())
        add(adds, k * nb, 1)
        w = nb - 1
        while w > 1:
            w = -(-w // 2)
            add(adds, k * w, 1)
        add(chains, k, 1)
    add(chains, 1, 1)
    return (sorted(adds.items(), key=lambda kv: -kv[0]),
            sorted(chains.items(), key=lambda kv: -kv[0]))


# K2 and K5 shapes besides the prove's: K2 with the leaves in order and
# through random orders over fewer rows, at the earlier slices' edge shapes
# and at the G2 team boundary (kSplitMax = 2048 chains and one more); K5 at
# 1, 2 and 64 points, at the boundary (2048 and 2049 points) and at 2^14
K2_EDGE = ((1 << 15, 32, False), (1 << 15, 32, True), (5 * 64, 5, True),
           (2048 * 32, 32, True), (2049 * 32, 32, True))
K5_EDGE = (1, 2, 64, 2048, 2049, 1 << 14)


def team_checks(record, rng, curve, log2: int) -> list:
    """K2 and K5 (G1, G2) against their plain versions, bit for bit: K2 at
    the shapes of K2_EDGE (10% of the leaves flagged), then at the prove's
    (batch * npad, 32) through the sort order of random digits over npad
    leaves (1% flagged), as `_windows` calls it; K5 at K5_EDGE, then at
    every shape of k5_shapes(log2). Each shape is timed by CUDA events
    (`ms`, which for a few points is mostly the host's launch overhead) and
    by the profiler's device time (`device_ms`); the main-path shapes also
    beside their bound, with the team's lanes, threads and block size and
    their launches in one 2^log2 prove. Returns one record a main-path
    shape."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_rcb
    from ckb_zkp_tpu_torch.ops.msm import _RCB_B, DeviceCurveGroup, device_group

    sizes = path_shapes(log2, 256)
    npad = 1 << log2
    c = DeviceCurveGroup._msm_window_bits(npad)
    k = sizes["scan_prefix_madd"] // npad
    nwin = 256 // c
    rows = []
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        rg, cs, ext = dg.rg, dg.cf.coord_shape, dg.cf.ext
        eb, imad = ext * fq_bytes(dg.fq.L), imad_per_mul(dg.fq.L)
        msms = 4 if group == "g1" else 1  # MSMs of each group in a prove
        shapes = [(M, B, "random" if o else "identity", False) for M, B, o in K2_EDGE]
        shapes.append((k * npad, _RCB_B, "sorted digits", True))
        for M, B, how, main in shapes:
            nl = npad if main else (M if how == "identity" else M // 2 + 3)
            X, Y = (rand_field(rng, nl, cs, dg.fq) for _ in range(2))
            inf = torch.as_tensor(rng.random(nl) < (0.01 if main else 0.1), device=DEVICE)
            xw, yw = cuda_rcb.pack_limbs_flag(rg, X, Y, inf)
            del X, Y
            if how == "identity":
                order = None
            elif main:
                gen = torch.Generator(device=DEVICE)
                gen.manual_seed(int(rng.integers(1 << 62)))
                digits = torch.randint(0, 1 << c, (k, npad), generator=gen, device=DEVICE)
                order = torch.sort(digits, dim=1).indices.reshape(-1)
                del digits
            else:
                order = torch.as_tensor(rng.integers(0, nl, M), device=DEVICE)
            live = M - int((inf if order is None else inf[order]).sum())

            def fn():
                return cuda_rcb.scan_prefix_madd(rg, xw, yw, B, order=order)

            pl, plain_ms = timed_once(
                lambda: cuda_rcb.scan_prefix_madd_plain(rg, xw, yw, B, order))
            out = fn()
            err = max_abs_err(out[0] + out[1], pl[0] + pl[1])
            del out, pl
            work = (M * eb + (0 if order is None else 8 * M) + 3 * M * eb
                    + 3 * (M // B) * eb, live * fq_muls("madd", ext) * imad)
            rows.append(team_row(record, rg, "scan_prefix_madd", group, M, B, M // B, fn,
                                 err, plain_ms, work, main,
                                 msms * -(-nwin // k) if main else 0,
                                 f"{group} N={M} B={B}, leaves {how}"))
            del xw, yw, order, inf
            torch.cuda.empty_cache()
        shapes = [(n, 0, False) for n in K5_EDGE]
        shapes += [(n, msms * t, True) for n, t in k5_shapes(log2)]
        for n, launches, main in shapes:
            P = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
            Q = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))

            def fn():
                return cuda_rcb.rcb_add(rg, P, Q)

            pl, plain_ms = timed_once(
                lambda: chunked_plain(cuda_rcb.rcb_add_plain, rg, P, Q))
            err = max_abs_err(fn(), pl)
            del pl
            work = (9 * n * eb, n * fq_muls("add", ext) * imad)
            rows.append(team_row(record, rg, "rcb_add", group, n, None, n, fn, err,
                                 plain_ms, work, main, launches, f"{group} n={n}"))
            del P, Q
        torch.cuda.empty_cache()
    return [r for r in rows if r["main"]]


def team_row(record, rg, name, group, size, B, teams, fn, err, plain_ms, work, main,
             launches, what) -> dict:
    """Time fn (a K2 or K5 call) by events and by device time, record it
    against its plain version and return its row."""
    from ckb_zkp_tpu_torch.ops import cuda_rcb

    reps = 3 if size >= 1 << 20 else 20
    ms = cuda_ms(fn, reps)
    dev = device_ms(fn, reps)
    lanes, block = cuda_rcb.team_shape(rg, teams)
    record(name, err, ms, plain_ms,
           f"{what}, {teams * lanes} threads ({lanes} a team) in blocks of {block}, "
           f"device {dev} ms" + ("; main path" if main else ""), work if main else None)
    row = {"name": name, "group": group, "size": size, "B": B, "launches_prove": launches,
           "lanes": lanes, "threads": teams * lanes, "block": block, "ms": ms,
           "device_ms": dev, "plain_ms": plain_ms, "main": main}
    return row | (bound(*work) if main else {})


# K3/K4 shapes besides the prove's levels: the earlier slices' edge shapes
# and ragged chain counts (4229 chains fill the last 256-thread block only
# in part, G1 and G2; 67 chains of B = 5 run in one-warp blocks)
SCAN_EDGE = ((1 << 15, 32), (5 * 64, 5), (4229 * 32, 32), (67 * 5, 5))


def scan_level_checks(record, rng, curve, log2: int) -> list:
    """K3 and K4 (G1, G2) against their plain versions, bit for bit, at the
    shapes of SCAN_EDGE and then at every (M, B) of scan_levels(log2), each
    level timed beside its bound, with the team kernel's threads (8 or 32
    lanes a chain) and block size. Returns one record a level."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_rcb
    from ckb_zkp_tpu_torch.ops.msm import device_group

    levels = []
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        rg, cs, ext = dg.rg, dg.cf.coord_shape, dg.cf.ext
        eb, imad = ext * fq_bytes(dg.fq.L), imad_per_mul(dg.fq.L)
        shapes = [(name, M, B, False) for M, B in SCAN_EDGE
                  for name in ("scan_prefix_add", "scan_total_add")]
        shapes += [(name, M, B, True) for name, M, B in scan_levels(log2)]
        for name, M, B, main in shapes:
            pts = tuple(rand_field(rng, M, cs, dg.fq) for _ in range(3))
            kern = getattr(cuda_rcb, name)
            plain = getattr(cuda_rcb, name + "_plain")
            pl, plain_ms = timed_once(lambda: plain(rg, pts, B))
            k = kern(rg, pts, B)
            if name == "scan_prefix_add":
                k, pl = k[0] + k[1], pl[0] + pl[1]
            chains = M // B
            team, block = cuda_rcb.team_shape(rg, chains)
            lanes = chains * team
            w_out = 3 * M * eb if name == "scan_prefix_add" else 0
            work = (3 * M * eb + w_out + 3 * chains * eb,
                    M * fq_muls("add", ext) * imad)
            ms = cuda_ms(lambda: kern(rg, pts, B), 5)
            record(name, max_abs_err(k, pl), ms, plain_ms,
                   f"{group} N={M} B={B}, {chains} chains, {lanes} threads in blocks of "
                   f"{block}" + ("; main path" if main else ""), work if main else None)
            if main:
                levels.append({"name": name, "group": group, "M": M, "B": B,
                               "chains": chains, "threads": lanes, "block": block,
                               "ms": ms, "plain_ms": plain_ms, **bound(*work)})
            del pts, k, pl
        torch.cuda.empty_cache()
    return levels


# fixed-base point counts besides the setup's width: one point, a partial
# warp, and the G2 team boundary (kSplitMax = 2048 points and one more)
FB_EDGE = (1, 7, 2047, 2048, 2049)


def fixed_base_scalars(rng, n: int, r: int):
    """n scalars as (n, 16) canonical limbs on the card, uniform below r's
    top limb, with the edge rows first (as many as fit): 0, r - 1, windows
    8-23 zero (a run of zero digits), every even window zero, every digit
    255 (below r's top limb)."""
    import torch

    from ckb_zkp_tpu_torch.ops.limbs import ints_to_limbs

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(int(rng.integers(1 << 62)))
    s = torch.randint(0, 1 << 16, (n, 16), generator=gen, device=DEVICE, dtype=torch.int32)
    s[:, -1] = torch.randint(0, r >> 240, (n,), generator=gen, device=DEVICE,
                             dtype=torch.int32)
    edge = torch.as_tensor(ints_to_limbs([0, r - 1], 16).astype("int32"), device=DEVICE)
    k = min(n, 5)
    rows = torch.cat([edge, s[2:5].clone()])[:k]
    if k > 2:
        rows[2, 4:12] = 0
    if k > 3:
        rows[3] &= 0xFF00
    if k > 4:
        rows[4, :-1] = 0xFFFF
    s[:k] = rows
    return s


def fixed_base_checks(record, rng, curve, log2: int,
                      plain_rows: int | None = None) -> tuple[list, dict]:
    """K6's fixed-base kernel (G1, G2) against its plain version, bit for
    bit, on random window tables: at the point counts of FB_EDGE with the
    edge scalars of `fixed_base_scalars`, then at the setup's width
    (`path_shapes(log2)`, plain in chunks of points), where its projective
    totals must also equal the per-window loop's that it replaced (the
    digits, the two table-row gathers and the elementwise K6 a window, on
    the card). Each width row: the kernel's, the plain version's and the
    loop's ms (events; kernel and loop also by device time), the bound for
    the live steps this run's digits need (11 field products a step, 42
    over Fq2) and the bytes (scalars, the tables once, the totals), the
    registers and spills from the build log. Returns the rows and the
    elementwise K6's launches in the loop's checked runs (one a group).
    `plain_rows`: at the setup's width, the plain version runs on that
    leading slice of the points only (its time is the slice's), and the
    loop is not run at 12 words (the elementwise K6 has no 12-word
    instance)."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_build, cuda_rcb
    from ckb_zkp_tpu_torch.ops.msm import device_group
    from ckb_zkp_tpu_torch.probes.levels import registers
    from ckb_zkp_tpu_torch.probes.levels import window_loop as loop

    log = os.path.join(cuda_build.BUILD_DIR, "build.log")
    regs = registers(open(log).read()) if os.path.exists(log) else []
    r = curve.fr.modulus
    n_full = path_shapes(log2, 256)["rcb_fixed_base"]
    rows, loop_launches = [], 0
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        rg, cs, ext = dg.rg, dg.cf.coord_shape, dg.cf.ext
        eb, imad = ext * fq_bytes(dg.fq.L), imad_per_mul(dg.fq.L)
        nw = dg.fq.L // 2
        rows_tab = cuda_rcb.FB_WINDOWS * cuda_rcb.FB_ROWS
        X, Y = (rand_field(rng, rows_tab, cs, dg.fq).reshape(
            cuda_rcb.FB_WINDOWS, cuda_rcb.FB_ROWS, *cs) for _ in range(2))
        for n in FB_EDGE + (n_full,):
            sc = fixed_base_scalars(rng, n, r)
            main = n == n_full

            def fn():
                return cuda_rcb.rcb_fixed_base(rg, X, Y, sc)

            def plain(rg_, s):
                return cuda_rcb.rcb_fixed_base_plain(rg_, X, Y, s[0])

            k = n if plain_rows is None or not main else min(n, plain_rows)
            pl, plain_ms = timed_once(lambda: chunked_plain(plain, rg, (sc[:k],)))
            out = fn()
            err = max_abs_err(tuple(c[:k] for c in out), pl)
            del pl
            what = f"{group} n={n}, {cuda_rcb.FB_WINDOWS} windows"
            if not main:
                record("rcb_fixed_base", err, cuda_ms(fn, 5), plain_ms, what)
                continue
            if nw == 8:
                before = cuda_build.COUNTS["rcb_madd"]
                lp = loop(rg, X, Y, sc)
                loop_launches += cuda_build.COUNTS["rcb_madd"] - before
                if max_abs_err(out, lp):
                    raise AssertionError(f"rcb_fixed_base != the per-window loop ({group})")
                del lp
            del out
            live = sum(int((((sc >> sh) & 0xFF) != 0).sum()) for sh in (0, 8))
            work = (n * cuda_rcb.FB_LIMBS * 4 + 2 * rows_tab * eb + 3 * n * eb,
                    live * fq_muls("madd", ext) * imad)
            ms = cuda_ms(fn, 5)
            loop_ms = cuda_ms(lambda: loop(rg, X, Y, sc), 2) if nw == 8 else None
            kern = (f"rcb_fixed_base_kernel<{nw},1>" if ext == 1
                    else f"rcb_team_fixed_base<{nw},2,0>")
            reg = [x for x in regs if x[0] == kern]
            record("rcb_fixed_base", err, ms, plain_ms,
                   f"{what}, {live} live steps; main path (setup)"
                   + (f"; the per-window loop {loop_ms:.6f} ms" if loop_ms else "")
                   + (f"; plain on the first {k} points" if k < n else ""), work,
                   **({"plain_rows": k} if k < n else {}))
            rows.append({"group": group, "n": n, "windows": cuda_rcb.FB_WINDOWS,
                         "live_steps": live, "ms": ms, "device_ms": device_ms(fn, 3),
                         "plain_ms": plain_ms, "plain_rows": k, "loop_ms": loop_ms,
                         "loop_device_ms": (device_ms(lambda: loop(rg, X, Y, sc), 2)
                                            if nw == 8 else None),
                         "kernel": kern, "registers": reg[0][1] if reg else None,
                         "spill_bytes": reg[0][2] if reg else None, **bound(*work)})
            torch.cuda.empty_cache()
        del X, Y
    return rows, {"rcb_madd": loop_launches}


def jacobian_fixed_base_checks(record, rng, curve, log2: int) -> list:
    """K9a's fixed-base kernel (G1, G2) against its plain version, bit for
    bit, on random window tables: at the point counts of FB_EDGE with the
    edge scalars of `fixed_base_scalars`, then at the setup's width
    (`path_shapes(log2)`, plain in chunks of points), where its totals,
    normalized, must also equal the normalized totals of the per-window
    loop that it replaced (the digits, two table-row gathers and the
    elementwise K9a a window, on the card). Each width row: the kernel's,
    the plain version's and the loop's ms (events; kernel and loop also by
    device time), the loop's elementwise K9a launches, the bound for the
    live steps this run's digits need (11 field products a step, 33 over
    Fq2) and the bytes (scalars, the tables once, the totals), the
    registers and spills from the build log. Returns the rows."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_build, cuda_ec, cuda_rcb
    from ckb_zkp_tpu_torch.ops.msm import device_group
    from ckb_zkp_tpu_torch.probes.levels import jacobian_window_loop as loop
    from ckb_zkp_tpu_torch.probes.levels import registers

    log = os.path.join(cuda_build.BUILD_DIR, "build.log")
    regs = registers(open(log).read()) if os.path.exists(log) else []
    r = curve.fr.modulus
    n_full = path_shapes(log2, 256)["ec_fixed_base"]
    rows = []
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        cf, cs, ext = dg.cf, dg.cf.coord_shape, dg.cf.ext
        eb = ext * FQ_BYTES
        rows_tab = cuda_rcb.FB_WINDOWS * cuda_rcb.FB_ROWS
        X, Y = (rand_field(rng, rows_tab, cs, dg.fq).reshape(
            cuda_rcb.FB_WINDOWS, cuda_rcb.FB_ROWS, *cs) for _ in range(2))
        for n in FB_EDGE + (n_full,):
            sc = fixed_base_scalars(rng, n, r)
            main = n == n_full

            def fn():
                return cuda_ec.ec_fixed_base(cf, X, Y, sc)

            def plain(cf_, s):
                return cuda_ec.ec_fixed_base_plain(cf_, X, Y, s[0])

            pl, plain_ms = timed_once(lambda: chunked_plain(plain, cf, (sc,)))
            out = fn()
            err = max_abs_err(out, pl)
            del pl
            what = f"{group} n={n}, {cuda_rcb.FB_WINDOWS} windows"
            if not main:
                record("ec_fixed_base", err, cuda_ms(fn, 5), plain_ms, what)
                continue
            before = cuda_build.COUNTS["ec_madd"]
            lp = loop(cf, X, Y, sc)
            loop_launches = cuda_build.COUNTS["ec_madd"] - before
            if max_abs_err(dg._normalize(out), dg._normalize(lp)):
                raise AssertionError(f"ec_fixed_base != the per-window loop after "
                                     f"normalization ({group})")
            del out, lp
            live = sum(int((((sc >> sh) & 0xFF) != 0).sum()) for sh in (0, 8))
            work = (n * cuda_rcb.FB_LIMBS * 4 + 2 * rows_tab * eb + 3 * n * eb,
                    live * fq_muls("jmadd", ext) * IMAD_PER_FQ_MUL)
            ms = cuda_ms(fn, 5)
            loop_ms = cuda_ms(lambda: loop(cf, X, Y, sc), 2)
            kern = f"ec_fixed_base_kernel<8,{ext}>"
            reg = [x for x in regs if x[0] == kern]
            record("ec_fixed_base", err, ms, plain_ms,
                   f"{what}, {live} live steps, normalized equal to the per-window loop; "
                   f"main path (setup); the loop {loop_ms:.6f} ms", work)
            rows.append({"group": group, "n": n, "windows": cuda_rcb.FB_WINDOWS,
                         "live_steps": live, "ms": ms, "device_ms": device_ms(fn, 3),
                         "plain_ms": plain_ms, "loop_ms": loop_ms,
                         "loop_launches": loop_launches,
                         "loop_device_ms": device_ms(lambda: loop(cf, X, Y, sc), 2),
                         "kernel": kern, "registers": reg[0][1] if reg else None,
                         "spill_bytes": reg[0][2] if reg else None, **bound(*work)})
            torch.cuda.empty_cache()
        del X, Y
    return rows


def _edge_rows(cf, P, Q) -> None:
    """Rows 0-3 of (P, Q) in place, as far as they reach: Q = P (the
    doubling), P infinite, Q infinite, Q = -P (a sum with Z = 0)."""
    n = P[0].shape[0]
    for c in range(3):
        Q[c][0] = P[c][0]
    if n > 1:
        P[2][1] = 0
    if n > 2:
        Q[2][2] = 0
    if n > 3:
        Q[0][3], Q[1][3], Q[2][3] = P[0][3], cf.neg(P[1][3]), P[2][3]


def _chain_operands(cf, rng, dg, k: int, dbl: list, from_infinity: bool):
    """init (k,) and addends (R, k) for a chain of K8 steps: random points,
    the fold's from infinity. Outside the fold, point 0's first addend is
    the negation of its accumulator after the first doublings (P == -Q,
    then an infinite accumulator takes the next addend) and point 1's
    first addend that accumulator itself (P == Q), computed by the plain
    version."""
    from ckb_zkp_tpu_torch.ops import cuda_ec, ec

    cs = cf.coord_shape
    R = len(dbl)
    init = (ec.point_infinity(cf, (k,)) if from_infinity
            else tuple(rand_field(rng, k, cs, dg.fq) for _ in range(3)))
    add = tuple(rand_field(rng, R * k, cs, dg.fq).reshape(R, k, *cs) for _ in range(3))
    if not from_infinity:
        acc = tuple(c.clone() for c in init)
        for _ in range(dbl[0]):
            acc = cuda_ec.ec_add_plain(cf, acc, acc)
        neg = ec.ec_neg(cf.plain, acc)
        for c in range(3):
            add[c][0, 0] = neg[c][0]
            if k > 1:
                add[c][0, 1] = acc[c][1]
    return init, add


def _chain_work(cf, init, add, dbl, eb: int) -> tuple:
    """(bytes, IMADs) of a chain: its operands and totals once; 7 field
    products a doubling of a finite accumulator and 16 an add of two
    finite points (x3 over Fq2), counted on the plain version's run."""
    from ckb_zkp_tpu_torch.ops import cuda_ec

    k = init[0].shape[0]
    acc, prods = tuple(init), 0
    for r, d in enumerate(dbl):
        q = tuple(a[r] for a in add)
        prods += 7 * d * int((~cf.is_zero(acc[2])).sum())
        for _ in range(d):
            acc = cuda_ec.ec_add_plain(cf, acc, acc)
        prods += 16 * int((~cf.is_zero(acc[2]) & ~cf.is_zero(q[2])).sum())
        acc = cuda_ec.ec_add_plain(cf, acc, q)
    return ((6 + 3 * len(dbl)) * k * eb,
            prods * (3 if cf.ext == 2 else 1) * IMAD_PER_FQ_MUL)


def jacobian_shape_checks(record, rng, curve, log2: int) -> list:
    """K8 (G1, G2) at every shape of the 2^log2 Jacobian prove
    (`k8_shapes`), with rows 0-3 the doubling, infinity on either side and
    P == -Q (`_edge_rows`), against its plain version and the one-thread
    K8, bit for bit; then K8's chain at the shapes the prove gives it
    (`_window_sums`' k points and c, 0 doublings; the fold's one point and
    W rounds of c from infinity), with infinite, P ==
    -Q and P == Q accumulators (`_chain_operands`), against its plain
    version and against the loop of K8 launches it replaced. Each row: ms
    by events and device ms (`device_ms`), the one-thread K8's device ms,
    lanes a point (`cuda_ec.ec_team_lanes`), threads, bound and launches in
    one prove. Returns one record a shape."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_ec
    from ckb_zkp_tpu_torch.ops.msm import _FIXED_BASE_BITS, device_group

    adds, chains = k8_shapes(log2)
    c, nwin = _FIXED_BASE_BITS, 256 // _FIXED_BASE_BITS
    rows = []
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        cf, cs, ext = dg.cf, dg.cf.coord_shape, dg.cf.ext
        eb = ext * FQ_BYTES
        msms = 4 if group == "g1" else 1  # MSMs of each group in a prove
        for n, t in adds:
            P = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
            Q = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
            _edge_rows(cf, P, Q)

            def fn():
                return cuda_ec.ec_add(cf, P, Q)

            def thread():
                return cuda_ec.ec_add(cf, P, Q, thread=True)

            pl, plain_ms = timed_once(lambda: chunked_plain(cuda_ec.ec_add_plain, cf, P, Q))
            out = fn()
            err = max_abs_err(out, pl)
            if max_abs_err(out, thread()):
                raise AssertionError(f"K8's team != the one-thread K8 ({group}, n={n})")
            del pl, out
            lanes = cuda_ec.ec_team_lanes(cf, n)
            work = (9 * n * eb, n * fq_muls("jadd", ext) * IMAD_PER_FQ_MUL)
            reps = 10 if n >= 1 << 14 else 20
            ms = cuda_ms(fn, reps)
            dev = device_ms(fn, reps)
            record("ec_add", err, ms, plain_ms,
                   f"{group} n={n}, {n * lanes} threads ({lanes} a point), device {dev} ms; "
                   f"main path (prove)", work)
            rows.append({"name": "ec_add", "group": group, "points": n,
                         "launches_prove": msms * t, "lanes": lanes, "threads": n * lanes,
                         "ms": ms, "device_ms": dev,
                         "thread_device_ms": device_ms(thread, reps), "plain_ms": plain_ms,
                         **bound(*work)})
            del P, Q
        for k, t in chains:
            fold = k == 1
            dbl = [c] * nwin if fold else [c, 0]
            init, add = _chain_operands(cf, rng, dg, k, dbl, fold)

            def fn():
                return cuda_ec.ec_add_chain(cf, init, add, dbl)

            def loop():  # the K8 launches it replaced
                acc = init
                for r, d in enumerate(dbl):
                    for _ in range(d):
                        acc = cuda_ec.ec_add(cf, acc, acc)
                    acc = cuda_ec.ec_add(cf, acc, tuple(a[r] for a in add))
                return acc

            pl, plain_ms = timed_once(lambda: cuda_ec.ec_add_chain_plain(cf, init, add, dbl))
            out = fn()
            err = max_abs_err(out, pl)
            if max_abs_err(out, loop()):
                raise AssertionError(f"K8's chain != the loop of K8 launches ({group}, k={k})")
            del pl, out
            lanes = cuda_ec.ec_team_lanes(cf, k)
            work = _chain_work(cf, init, add, dbl, eb)
            ms = cuda_ms(fn, 5)
            dev = device_ms(fn, 5)
            what = "the fold" if fold else "_window_sums"
            record("ec_add_chain", err, ms, plain_ms,
                   f"{group} k={k}, {len(dbl)} rounds ({what}), {k * lanes} threads, device "
                   f"{dev} ms; main path (prove)", work)
            rows.append({"name": "ec_add_chain", "group": group, "points": k,
                         "rounds": len(dbl), "doublings": sum(dbl),
                         "launches_prove": msms * t, "lanes": lanes, "threads": k * lanes,
                         "ms": ms, "device_ms": dev,
                         "loop_device_ms": device_ms(loop, 3),
                         "loop_launches": sum(dbl) + len(dbl), "plain_ms": plain_ms,
                         **bound(*work)})
        torch.cuda.empty_cache()
    return rows


# K9b and K9c shapes besides the prove's, as (blocks, B): one block, 67
# blocks of B = 5 (fewer chains than a warp), 4229 of 32 (the last block
# of threads filled in part) and the G2 team boundary (kEcSplitMax = 2048
# chains and one more)
TOTALS_EDGE = ((1, 32), (67, 5), (4229, 32), (2048, 32), (2049, 32))


def _totals_leaves(cf, rng, dg, n: int, B: int, edges: bool):
    """n affine leaves (X, Y, inf) on the card. With `edges`, 10% flagged
    and block 0 (of B leaves) holds the mixed add's branches: leaf 1 =
    -leaf 0 (P == -Q: a sum with Z = 0), leaf 2 taken by that infinite
    accumulator, leaf 3 = leaf 2 (P == Q: the doubling); block 1 starts
    with a flagged leaf (an infinite accumulator takes (x2, y2, 0)).
    Without, 1% flagged (the prove's leaves)."""
    import torch

    cs = cf.coord_shape
    X, Y = rand_field(rng, n, cs, dg.fq), rand_field(rng, n, cs, dg.fq)
    inf = torch.as_tensor(rng.random(n) < (0.1 if edges else 0.01), device=DEVICE)
    if edges:
        inf[:4] = False
        X[1], Y[1] = X[0], cf.neg(Y[:1])[0]
        X[3], Y[3] = X[2], Y[2]
        if n > B:
            inf[B] = True
    return X, Y, inf


def _totals_points(cf, rng, dg, n: int, B: int):
    """n general-Z Jacobian points on the card, 10% at infinity (Z = 0);
    block 0 holds the add's branches: point 1 = point 0 (P == Q: the
    doubling), point 2 = -2 point 0 (P == -Q: a sum with Z = 0), point 3
    taken by that infinite accumulator; block 1 starts at infinity."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_ec, ec

    pts = tuple(rand_field(rng, n, cf.coord_shape, dg.fq) for _ in range(3))
    inf = torch.as_tensor(rng.random(n) < 0.1, device=DEVICE)
    inf[:4] = False
    if n > B:
        inf[B] = True
    pts[2][inf] = 0
    p0 = tuple(c[:1] for c in pts)
    neg2 = ec.ec_neg(cf.plain, cuda_ec.ec_add_plain(cf, p0, p0))
    for c in range(3):
        pts[c][1], pts[c][2] = pts[c][0], neg2[c][0]
    return pts


def jacobian_totals_checks(record, rng, curve, log2: int) -> list:
    """K9b and K9c (G1, G2) against their plain versions, bit for bit. K9b
    at the shapes of TOTALS_EDGE (`_totals_leaves` with its edges), with
    the leaves in order and through a random permutation of them; then at
    the prove's (jb * npad, 32) through the sort order of random digits
    over npad leaves (1% flagged), as `_window_sums` calls it. K9c at
    TOTALS_EDGE (`_totals_points`) and at the prove's jb * npad / 32
    points. Each main-path shape is timed by CUDA events (its launches
    last 0.18 ms or more, so events hold little host overhead) beside its
    bound; K9b also beside the path it replaced, the sorted copy of the
    leaves (also timed alone) and K9b over it. K9c's old kernel, one
    thread a chain, is gone: `probes/levels.py --parent` times it in an
    earlier tree. Returns one record a main-path shape and curve."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_ec
    from ckb_zkp_tpu_torch.ops.msm import _FIXED_BASE_BITS, _SCAN_B, device_group

    sizes = path_shapes(log2, 256)
    npad, B = 1 << log2, _SCAN_B
    jb = sizes["ec_block_totals_madd"] // npad
    batches = -(-(256 // _FIXED_BASE_BITS) // jb)  # window batches a MSM
    rows = []
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        cf, cs, ext = dg.cf, dg.cf.coord_shape, dg.cf.ext
        eb = ext * FQ_BYTES
        msms = 4 if group == "g1" else 1  # MSMs of each group in a prove
        for G, b in TOTALS_EDGE:
            lv = _totals_leaves(cf, rng, dg, G * b, b, True)
            pl = cuda_ec.block_totals_madd_plain(cf, lv, b)
            perm = torch.as_tensor(rng.permutation(G * b), device=DEVICE)
            pool = tuple(c[perm] for c in lv)  # pool row p holds leaf perm[p]
            order = torch.argsort(perm)
            if max_abs_err(cuda_ec.block_totals_madd(cf, lv, b), pl):
                raise AssertionError(f"ec_block_totals_madd ({group}, {G} x {b}, leaves in "
                                     "order) != plain")
            _, plain_ms = timed_once(lambda: cuda_ec.block_totals_madd_plain(cf, pool, b, order))
            record("ec_block_totals_madd", max_abs_err(
                cuda_ec.block_totals_madd(cf, pool, b, order), pl),
                cuda_ms(lambda: cuda_ec.block_totals_madd(cf, pool, b, order), 5), plain_ms,
                f"{group} N={G * b} B={b}, leaves in order and permuted")
        lv = _totals_leaves(cf, rng, dg, npad, B, False)
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(int(rng.integers(1 << 62)))
        digits = torch.randint(0, 1 << _FIXED_BASE_BITS, (jb, npad), generator=gen,
                               device=DEVICE)
        order = torch.sort(digits, dim=1).indices.reshape(-1)
        M = order.shape[0]
        G = M // B
        del digits

        def sort_copy():
            return tuple(c[order] for c in lv)

        def old():  # the MSM before: the sorted copy, then K9b over it
            return cuda_ec.block_totals_madd(cf, sort_copy(), B)

        def fn():
            return cuda_ec.block_totals_madd(cf, lv, B, order)

        pl, plain_ms = timed_once(lambda: cuda_ec.block_totals_madd_plain(cf, lv, B, order))
        if max_abs_err(old(), pl):
            raise AssertionError(f"ec_block_totals_madd (sorted copy, {group}, N={M}) != plain")
        err = max_abs_err(fn(), pl)
        del pl
        live = (~lv[2][order]).reshape(G, B)
        adds = int(live.sum()) - int(live.any(1).sum())  # the first live leaf copies
        work = (npad * (2 * eb + 1) + 8 * M + 3 * G * eb,
                adds * fq_muls("jmadd", ext) * IMAD_PER_FQ_MUL)
        ms = cuda_ms(fn, 5)
        record("ec_block_totals_madd", err, ms, plain_ms,
               f"{group} N={M} B={B}, leaves through the sort order, one thread a chain; "
               "main path (prove)", work)
        rows.append({"name": "ec_block_totals_madd", "group": group, "N": M, "B": B,
                     "chains": G, "launches_prove": msms * batches, "threads": G, "ms": ms,
                     "sorted_copy_ms": cuda_ms(sort_copy, 5), "old_ms": cuda_ms(old, 5),
                     "plain_ms": plain_ms, **bound(*work)})
        del lv, order
        torch.cuda.empty_cache()
        shapes = [(G, b, False) for G, b in TOTALS_EDGE]
        shapes.append((sizes["ec_block_totals_add"] // B, B, True))
        for G, b, main in shapes:
            M = G * b
            pts = (tuple(rand_field(rng, M, cs, dg.fq) for _ in range(3)) if main
                   else _totals_points(cf, rng, dg, M, b))

            def fn():
                return cuda_ec.block_totals_add(cf, pts, b)

            pl, plain_ms = timed_once(lambda: cuda_ec.block_totals_add_plain(cf, pts, b))
            lanes = cuda_ec.ec_team_lanes(cf, G)
            what = f"{group} N={M} B={b}, {G * lanes} threads ({lanes} a chain)"
            if not main:
                record("ec_block_totals_add", max_abs_err(fn(), pl), cuda_ms(fn, 5), plain_ms,
                       what)
                continue
            work = (3 * M * eb + 3 * G * eb, (M - G) * fq_muls("jadd", ext) * IMAD_PER_FQ_MUL)
            ms = cuda_ms(fn, 10)
            record("ec_block_totals_add", max_abs_err(fn(), pl), ms, plain_ms,
                   f"{what}; main path (prove)", work)
            rows.append({"name": "ec_block_totals_add", "group": group, "N": M, "B": b,
                         "chains": G, "launches_prove": msms * batches, "lanes": lanes,
                         "threads": G * lanes, "ms": ms, "plain_ms": plain_ms,
                         **bound(*work)})
        torch.cuda.empty_cache()
    return rows


class Recorder:
    """Kernel-vs-plain comparisons. The kernel table keeps the times and
    the bound of each kernel's first comparison at a main-path shape."""

    def __init__(self, results: dict):
        self.results = results

    def __call__(self, name, err, ms, plain_ms, what, work=None, library_ms=None,
                 plain_rows=None):
        line = (f"kernel {name} [{what}]: max_abs_err={err} kernel_ms={ms:.6f} "
                f"plain_ms={plain_ms:.6f}")
        b = bound(*work) if work is not None else None
        if b is not None:
            line += f" bound_ms={b['bound_ms']:.6f} ({b['bound_by']})"
        log(line)
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version ({what})")
        r = self.results.setdefault(name, {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if b is not None and "ms" not in r:
            r.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **b)
            if plain_rows is not None:  # the plain version ran on a leading slice
                r["plain_rows"] = plain_rows


def mul_edge_check(record, rng, df, what: str) -> None:
    """K1 against its plain version at 2^16 elements of df, the first four
    products 0 * (p - 1), 1 * (p - 1), (p - 1)^2 and R * R also against
    their values."""
    import torch

    n = 1 << 16
    p = df.spec.modulus
    a = rand_field(rng, n, (df.L,), df)
    b = rand_field(rng, n, (df.L,), df)
    a[:4] = df.encode([0, 1, p - 1, df.R])
    b[:4] = df.encode([p - 1, p - 1, p - 1, df.R])
    k = df.mul(a, b)
    pl = df.plain.mul(a, b)
    torch.cuda.synchronize()
    if df.decode(k[:4]) != [0, p - 1, 1, df.R * df.R % p]:
        raise AssertionError(f"mont_mul edge values wrong ({what})")
    record("mont_mul", max_abs_err(k, pl), cuda_ms(lambda: df.mul(a, b), 50),
           cuda_ms(lambda: df.plain.mul(a, b), 5), f"{what} n=2^16")


def add_edge_checks(record, rng, curve, madd: bool) -> None:
    """K5 (and with `madd` the elementwise K6, with flagged leaves) at
    2^14 G1 and G2 points whose first rows are P + P, P + (-P) and
    identity operands, against the plain version and those rows against
    the host group."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_rcb
    from ckb_zkp_tpu_torch.ops.msm import device_group

    n = 1 << 14
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        rg, cs, host = dg.rg, dg.cf.coord_shape, dg.host_group
        gen = curve.g1_gen if group == "g1" else curve.g2_gen
        r0, r1, r2, r3 = (host.mul(gen, int(x)) for x in rng.integers(2, 1 << 60, 4))
        inf = host.infinity
        left = [r0, r1, inf, r3, inf, r1, r2]
        right = [r0, host.neg(r1), r2, inf, inf, r2, host.neg(r2)]
        k_edge = len(left)
        want = [host.add(x, y) for x, y in zip(left, right)]
        P = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
        Q = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
        for full, edge in ((P, rg.from_affine_enc(dg.encode_points(left))),
                           (Q, rg.from_affine_enc(dg.encode_points(right)))):
            for c_full, c_edge in zip(full, edge):
                c_full[:k_edge] = c_edge
        k = rg.add(P, Q)
        pl = cuda_rcb.rcb_add_plain(rg, P, Q)
        torch.cuda.synchronize()
        got = dg.decode_points_host(rg.to_jacobian(tuple(c[:k_edge] for c in k)))
        if got != want:
            raise AssertionError(f"rcb_add edge cases wrong ({curve.name} {group})")
        record("rcb_add", max_abs_err(k, pl),
               cuda_ms(lambda: rg.add(P, Q), 20),
               cuda_ms(lambda: cuda_rcb.rcb_add_plain(rg, P, Q), 2),
               f"{curve.name} {group} n=2^14")
        if not madd:
            continue
        xq, yq, zq = dg.encode_points(right)
        leaves = (rand_field(rng, n, cs, dg.fq), rand_field(rng, n, cs, dg.fq),
                  torch.as_tensor(rng.random(n) < 0.1, device=DEVICE))
        leaves[0][:k_edge], leaves[1][:k_edge] = xq, yq
        leaves[2][:k_edge] = dg.cf.is_zero(zq)
        k = rg.madd(P, leaves)
        pl = cuda_rcb.rcb_madd_plain(rg, P, leaves)
        torch.cuda.synchronize()
        got = dg.decode_points_host(rg.to_jacobian(tuple(c[:k_edge] for c in k)))
        if got != want:
            raise AssertionError(f"rcb_madd edge cases wrong ({group})")
        record("rcb_madd", max_abs_err(k, pl),
               cuda_ms(lambda: rg.madd(P, leaves), 20),
               cuda_ms(lambda: cuda_rcb.rcb_madd_plain(rg, P, leaves), 2),
               f"{group} n=2^14, flagged leaves")


def phase_kernels(results: dict, log2: int) -> list:
    import numpy as np
    import torch

    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_rcb
    from ckb_zkp_tpu_torch.ops.msm import device_group

    rng = np.random.default_rng(SEED)
    curve = get_curve("bn254")
    record = Recorder(results)

    g1 = device_group(curve, "g1", DEVICE)
    for fname, df in (("fr", g1.fr), ("fq", g1.fq)):
        mul_edge_check(record, rng, df, f"bn254 {fname}")
    add_edge_checks(record, rng, curve, madd=True)

    # every kernel at the shapes the slice gives it, K1 also with a
    # broadcast constant operand (to_mont/from_mont read it with step 0);
    # the plain side runs once, timed by that call
    sizes = path_shapes(log2, g1.fr.L * 16)
    n = sizes["mont_mul"]
    df = g1.fr
    a = rand_field(rng, n, (df.L,), df)
    b = rand_field(rng, n, (df.L,), df)
    for what, kf, pf, nin in (
        ("a*b", lambda: df.mul(a, b), lambda: df.plain.mul(a, b), 2),
        ("to_mont, step 0", lambda: df.to_mont(a), lambda: df.plain.to_mont(a), 1),
        ("from_mont, step 0", lambda: df.from_mont(a), lambda: df.plain.from_mont(a), 1),
    ):
        pl, plain_ms = timed_once(pf)
        record("mont_mul", max_abs_err(kf(), pl), cuda_ms(kf, 10), plain_ms,
               f"bn254 fr n={n} {what}; main path",
               ((nin + 1) * n * FQ_BYTES, n * IMAD_PER_FQ_MUL))
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        rg, cs, ext = dg.rg, dg.cf.coord_shape, dg.cf.ext
        eb = ext * FQ_BYTES  # bytes of one coordinate
        # the elementwise K6 at the per-window loop's width (off the path
        # since the fixed-base kernel), flags as often as a zero digit
        n = sizes["rcb_madd"]
        P = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
        leaves = (rand_field(rng, n, cs, dg.fq), rand_field(rng, n, cs, dg.fq),
                  torch.as_tensor(rng.random(n) < 1 / 256, device=DEVICE))
        live = n - int(leaves[2].sum())
        pl, plain_ms = timed_once(
            lambda: chunked_plain(cuda_rcb.rcb_madd_plain, rg, P, leaves))
        record("rcb_madd", max_abs_err(rg.madd(P, leaves), pl),
               cuda_ms(lambda: rg.madd(P, leaves), 5), plain_ms,
               f"{group} n={n}; the per-window loop's width, off the path",
               (6 * n * eb + 2 * live * eb + n,
                live * fq_muls("madd", ext) * IMAD_PER_FQ_MUL))
        del P, leaves, pl
    torch.cuda.empty_cache()
    fixed, loop_launches = fixed_base_checks(record, rng, curve, log2)
    torch.cuda.empty_cache()
    team = team_checks(record, rng, curve, log2)
    levels = scan_level_checks(record, rng, curve, log2)
    torch.cuda.empty_cache()
    jacobian_kernels(record, rng, curve, sizes)
    torch.cuda.empty_cache()
    jac_fixed = jacobian_fixed_base_checks(record, rng, curve, log2)
    torch.cuda.empty_cache()
    jac_shapes = jacobian_shape_checks(record, rng, curve, log2)
    torch.cuda.empty_cache()
    jac_totals = jacobian_totals_checks(record, rng, curve, log2)
    torch.cuda.empty_cache()

    # the port's MSM on both engines against the host-int MSM, small input
    prng = random.Random(SEED)
    for group, n in (("g1", 700), ("g2", 300)):
        dg = device_group(curve, group, DEVICE)
        host = dg.host_group
        gen = curve.g1_gen if group == "g1" else curve.g2_gen
        base = [host.mul(gen, prng.randrange(1, curve.fr.modulus)) for _ in range(16)]
        pts = [base[i % 16] for i in range(n)]
        pts[3] = host.infinity
        sc = [prng.randrange(curve.fr.modulus) for _ in range(n)]
        sc[5] = 0
        want = host.msm(pts, sc)
        for engine in ("rcb", "jacobian"):
            with jacobian_engine(curve, engine == "jacobian"):
                got = dg.decode_point(dg.msm(dg.encode_points(pts), dg.encode_scalars(sc)))
            if got != want:
                raise AssertionError(f"port MSM ({engine}) != host MSM ({group}, n={n})")
        log(f"msm {group} n={n}: both engines equal to the host-int MSM")
    return levels, team, fixed, loop_launches, jac_fixed, jac_shapes, jac_totals


@contextlib.contextmanager
def jacobian_engine(curve, on: bool = True, log2: int = 20):
    """The cached card groups on the Jacobian MSM engine for the block
    (`_use_rcb = False`), restored after. Below 2^20 the engine's tiling
    thresholds scale down by 2^(20 - log2), so that a 2^log2 slice runs a
    K9b and a K9c level as the 2^20 one does."""
    from ckb_zkp_tpu_torch.ops import msm

    groups = [msm.device_group(curve, g, DEVICE) for g in ("g1", "g2")]
    saved = (msm._LEAF_GROUPS, msm._JAC_TOP)
    shift = max(0, 20 - log2)
    try:
        if on:
            for g in groups:
                g._use_rcb = False
            msm._LEAF_GROUPS = max(1, saved[0] >> shift)
            msm._JAC_TOP = max(1, saved[1] >> shift)
        yield
    finally:
        for g in groups:
            g._use_rcb = True
        msm._LEAF_GROUPS, msm._JAC_TOP = saved


def jacobian_kernels(record, rng, curve, sizes) -> None:
    """K8 and K9a against their plain versions: at 2^14 with the edge cases
    (P = Q, P = -Q, identity on each side, flagged leaves, with general-Z
    accumulators) also against the host group; then K8 at the widest shape
    of the Jacobian prove and the elementwise K9a at the width the leaf
    branch of a 2^14 Jacobian MSM gives it (`leaf_shapes`; K8 at every
    shape: `jacobian_shape_checks`; K9b and K9c:
    `jacobian_totals_checks`)."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_ec, ec
    from ckb_zkp_tpu_torch.ops.msm import device_group

    n = 1 << 14
    inv2 = (curve.fr.modulus + 1) // 2
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        cf, cs, host = dg.cf, dg.cf.coord_shape, dg.host_group
        gen = curve.g1_gen if group == "g1" else curve.g2_gen
        r0, r1, r2, r3 = (host.mul(gen, int(x)) for x in rng.integers(2, 1 << 60, 4))
        inf = host.infinity
        left = [r0, r1, inf, r3, inf, r1, r2]
        right = [r0, host.neg(r1), r2, inf, inf, r2, host.neg(r2)]
        k_edge = len(left)
        want = [host.add(x, y) for x, y in zip(left, right)]

        def general_z(pts):  # the same points, doubled from their halves
            return dg.p_double(dg.encode_points([host.mul(p, inv2) for p in pts]))

        P = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
        Q = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
        for full, edge in ((P, general_z(left)), (Q, general_z(right))):
            for c_full, c_edge in zip(full, edge):
                c_full[:k_edge] = c_edge
        k = ec.ec_add(cf, P, Q)
        pl, plain_ms = timed_once(lambda: cuda_ec.ec_add_plain(cf, P, Q))
        if dg.decode_points_host(tuple(c[:k_edge] for c in k)) != want:
            raise AssertionError(f"ec_add edge cases wrong ({group})")
        record("ec_add", max_abs_err(k, pl), cuda_ms(lambda: ec.ec_add(cf, P, Q), 20),
               plain_ms, f"{group} n=2^14")
        xq, yq, zq = dg.encode_points(right)
        leaves = (rand_field(rng, n, cs, dg.fq), rand_field(rng, n, cs, dg.fq),
                  torch.as_tensor(rng.random(n) < 0.1, device=DEVICE))
        leaves[0][:k_edge], leaves[1][:k_edge] = xq, yq
        leaves[2][:k_edge] = cf.is_zero(zq)
        k = cuda_ec.ec_madd(cf, P, leaves)
        pl, plain_ms = timed_once(lambda: cuda_ec.ec_madd_plain(cf, P, leaves))
        if dg.decode_points_host(tuple(c[:k_edge] for c in k)) != want:
            raise AssertionError(f"ec_madd edge cases wrong ({group})")
        record("ec_madd", max_abs_err(k, pl),
               cuda_ms(lambda: cuda_ec.ec_madd(cf, P, leaves), 20), plain_ms,
               f"{group} n=2^14, flagged leaves")

    # the shapes of the 2^log2 Jacobian setup and prove; plain timed once
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        cf, cs, ext = dg.cf, dg.cf.coord_shape, dg.cf.ext
        eb = ext * FQ_BYTES
        n = sizes["ec_add"]
        P = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
        Q = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
        pl, plain_ms = timed_once(lambda: chunked_plain(cuda_ec.ec_add_plain, cf, P, Q))
        record("ec_add", max_abs_err(ec.ec_add(cf, P, Q), pl),
               cuda_ms(lambda: ec.ec_add(cf, P, Q), 10), plain_ms,
               f"{group} n={n}; main path (prove)",
               (9 * n * eb, n * fq_muls("jadd", ext) * IMAD_PER_FQ_MUL))
        n = sizes["ec_madd"]
        P = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
        leaves = (rand_field(rng, n, cs, dg.fq), rand_field(rng, n, cs, dg.fq),
                  torch.as_tensor(rng.random(n) < 1 / 256, device=DEVICE))
        live = n - int(leaves[2].sum())
        pl, plain_ms = timed_once(
            lambda: chunked_plain(cuda_ec.ec_madd_plain, cf, P, leaves))
        record("ec_madd", max_abs_err(cuda_ec.ec_madd(cf, P, leaves), pl),
               cuda_ms(lambda: cuda_ec.ec_madd(cf, P, leaves), 5), plain_ms,
               f"{group} n={n}, 1/256 flagged; main path (a 2^14 Jacobian MSM's leaf "
               "branch)",
               (8 * n * eb + n, live * fq_muls("jmadd", ext) * IMAD_PER_FQ_MUL))
        del P, Q, leaves, pl


def phase_setup_check(log2: int, curve_name: str = "bn254") -> dict:
    """The device setup of a (2^log2 - 2)-constraint square chain against
    the host-int instance map and the host-mode setup, point for point.
    Returns the shape and the device-branch parameters."""
    import torch

    from ckb_zkp_tpu_torch.bench_circuits import square_chain_shape
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.schemes import groth16
    from ckb_zkp_tpu_torch.schemes.groth16.qap import qap_matrices

    curve = get_curve(curve_name)
    fr = curve.fr.modulus
    prng = random.Random(SEED + 1)
    shape = square_chain_shape((1 << log2) - 2, fr, seed=SEED % 997)
    toxic = [prng.randrange(1, fr) for _ in range(5)]
    qap = qap_matrices(shape, curve.fr, DEVICE)
    nv = shape.num_variables
    got = tuple(qap.df.decode(x[:nv]) for x in qap.evaluations_at(toxic[-1]))
    if got != qap.evaluations_at_host(toxic[-1]):
        raise AssertionError("device instance map != host instance map")
    log(f"setup check {curve_name} 2^{log2}: device instance map (u, v, w) equals the "
        "host ints")
    dev = groth16.generate_parameters_from_shape(shape, curve, *toxic, device=DEVICE)
    host = groth16.generate_parameters_from_shape(
        shape, curve, *toxic, device=DEVICE, host_mode=True)
    ni = shape.num_inputs
    for name in ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query"):
        d, h = getattr(dev, name), getattr(host, name)
        off = ni if name == "l_query" else 0
        n = h[0].shape[0]
        if not all(torch.equal(dc[off : off + n], hc) for dc, hc in zip(d, h)):
            raise AssertionError(f"{name}: device branch != host mode")
        pad = torch.cat([d[2][:off], d[2][off + n :]])
        if bool(pad.any()):
            raise AssertionError(f"{name}: padding rows are not at infinity")
        log(f"setup check {curve_name} 2^{log2}: {name} {n} points equal, "
            f"{d[0].shape[0] - n} padding rows at infinity")
    if dev.vk != host.vk:
        raise AssertionError("device-branch and host-mode verifying keys differ")
    return {"curve": curve, "shape": shape, "params": dev}


def phase_slice(card: str, log2: int, curve_name: str = "bn254") -> dict:
    """Device setup, warm-up prove, timed prove and verdicts of the
    (2^log2 - 2)-constraint square chain on `curve_name`. Returns the run
    (curve, shape, toxic waste, parameters, r, s, proof) with the kernel
    launches of the setup and of the timed prove, each also as its 12-word
    launches (`cuda_build.WIDE`): on BLS12-381 the setup must launch K6's
    12-word instance 5 times and the prove every 12-word K1-K5."""
    import torch

    from ckb_zkp_tpu_torch.bench_circuits import square_chain_shape
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.schemes import groth16

    curve = get_curve(curve_name)
    wide = curve_name == "bls12_381"
    fr = curve.fr.modulus
    prng = random.Random(SEED)
    t0 = time.perf_counter()
    shape = square_chain_shape((1 << log2) - 2, fr, seed=SEED % 1000)
    log(f"slice {curve_name}: square_chain_shape((1 << {log2}) - 2): m = 2^{log2}, "
        f"{shape.num_variables} variables, built in {time.perf_counter() - t0:.3f} s")
    toxic = [prng.randrange(1, fr) for _ in range(5)]
    setup_t: dict = {}
    cuda_build.reset_counts()
    t0 = time.perf_counter()
    params = groth16.generate_parameters_from_shape(
        shape, curve, *toxic, device=DEVICE, timings=setup_t)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_launches = dict(cuda_build.COUNTS)
    setup_wide = dict(cuda_build.WIDE)
    log(f"setup {curve_name}: {setup_s:.3f} s {json.dumps(setup_t)} [{card}]")
    log(f"kernel launches in the setup: {json.dumps(setup_launches)}; 12-word "
        f"{json.dumps(setup_wide)}")
    if setup_launches["rcb_fixed_base"] != 5 or setup_launches["rcb_madd"]:
        raise AssertionError("the setup did not launch K6's fixed-base kernel once a query "
                             "(5 times) and the elementwise K6 (rcb_madd) no time")
    if setup_wide["rcb_fixed_base"] != (5 if wide else 0):
        raise AssertionError("the setup launched K6's fixed-base kernel at the wrong width")
    r, s = prng.randrange(1, fr), prng.randrange(1, fr)
    t0 = time.perf_counter()
    groth16.create_proof_from_shape(params, shape, r, s)
    torch.cuda.synchronize()
    log(f"warm-up prove: {time.perf_counter() - t0:.3f} s [{card}]")
    held = torch.cuda.memory_allocated()
    cuda_build.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    stages: dict = {}
    t0 = time.perf_counter()
    proof = groth16.create_proof_from_shape(params, shape, r, s, timings=stages)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = dict(cuda_build.COUNTS)
    prove_wide = dict(cuda_build.WIDE)
    ordered = cuda_build.ORDERED["scan_prefix_madd"]
    peak = torch.cuda.max_memory_allocated()
    after = torch.cuda.memory_allocated()
    log(f"timed prove {curve_name}: {prove_s:.3f} s, peak device memory {peak} bytes "
        f"[{card}]")
    log(f"device memory held: {held} bytes after the warm-up prove, {after} "
        f"after the timed prove")
    if after > held + (1 << 20):
        raise AssertionError("a prove left device memory behind")
    log(f"prove stages (s): {json.dumps(stages)} [{card}]")
    log(f"kernel launches in the timed prove: {json.dumps(launches)}; 12-word "
        f"{json.dumps(prove_wide)}")
    rcb_prove = (set(KERNELS) - SETUP_KERNELS - LOOP_KERNELS - JAC_SETUP_KERNELS
                 - JAC_PROVE_KERNELS - JAC_LEAF_KERNELS - PROBE_KERNELS)
    missing = [k for k in sorted(rcb_prove) if (prove_wide if wide else launches)[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the prove ({curve_name}): {missing}")
    log(f"K2 launches through a sort order in the timed prove: {ordered} of "
        f"{launches['scan_prefix_madd']}")
    if ordered != launches["scan_prefix_madd"]:
        raise AssertionError("the prove launched K2 without an order: a sorted copy of "
                             "the leaves came back")
    check_verdicts(curve, params, shape, proof)
    return {"curve": curve, "shape": shape, "toxic": toxic, "params": params,
            "r": r, "s": s, "proof": proof, "setup_launches": setup_launches,
            "prove_launches": launches, "setup_wide": setup_wide,
            "prove_wide": prove_wide, "setup_s": setup_s, "prove_s": prove_s,
            "setup_stages": setup_t, "prove_stages": stages}


def check_verdicts(curve, params, shape, proof) -> None:
    from ckb_zkp_tpu_torch.schemes import groth16

    fr = curve.fr.modulus
    pvk = groth16.prepare_verifying_key(curve, params.vk)
    publics = shape.input_assignment[1:]
    ok = groth16.verify_proof(curve, pvk, proof, publics)
    bad = groth16.verify_proof(curve, pvk, proof, [(publics[0] + 1) % fr])
    log(f"verify_proof: {ok}; tampered public input: {bad}")
    if ok is not True or bad is not False:
        raise AssertionError("the proof does not verify, or a tampered one does")


QUERIES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")


def phase_jacobian(card: str, run: dict, log2: int) -> dict:
    """The slice's setup and prove on the Jacobian MSM engine, held point
    for point against the RCB run `run` (same toxic waste, same r, s)."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.schemes import groth16

    curve, shape, rcb = run["curve"], run["shape"], run["params"]
    with jacobian_engine(curve, True, log2):
        cuda_build.reset_counts()
        setup_t: dict = {}
        t0 = time.perf_counter()
        params = groth16.generate_parameters_from_shape(
            shape, curve, *run["toxic"], device=DEVICE, timings=setup_t)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        setup_launches = dict(cuda_build.COUNTS)
        log(f"jacobian setup: {setup_s:.3f} s {json.dumps(setup_t)} [{card}]")
        log(f"kernel launches in the jacobian setup: {json.dumps(setup_launches)}")
        if setup_launches["ec_fixed_base"] != 5 or setup_launches["ec_madd"]:
            raise AssertionError("the Jacobian setup did not launch K9a's fixed-base kernel "
                                 "once a query (5 times) and the elementwise K9a (ec_madd) "
                                 "no time")
        for name in QUERIES:
            d, h = getattr(params, name), getattr(rcb, name)
            n = min(d[0].shape[0], h[0].shape[0])
            if not all(torch.equal(dc[:n], hc[:n]) for dc, hc in zip(d, h)):
                raise AssertionError(f"{name}: Jacobian setup != RCB setup")
            if bool(d[2][n:].any()) or bool(h[2][n:].any()):
                raise AssertionError(f"{name}: rows beyond the shared ones not at infinity")
            log(f"jacobian setup: {name} equal to the RCB setup's on {n} rows, limb "
                f"for limb ({d[0].shape[0]} and {h[0].shape[0]} rows)")
        if params.vk != rcb.vk:
            raise AssertionError("Jacobian and RCB verifying keys differ")
        cuda_build.reset_counts()
        stages: dict = {}
        t0 = time.perf_counter()
        proof = groth16.create_proof_from_shape(params, shape, run["r"], run["s"],
                                                timings=stages)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        launches = dict(cuda_build.COUNTS)
        ordered = cuda_build.ORDERED["ec_block_totals_madd"]
        traced = trace_window_sums(card, curve, run)
    log(f"jacobian prove: {prove_s:.3f} s {json.dumps(stages)} [{card}]")
    log(f"kernel launches in the jacobian prove: {json.dumps(launches)}")
    missing = [k for k in sorted(JAC_PROVE_KERNELS) if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the Jacobian prove: {missing}")
    adds, chains = k8_shapes(log2)
    # K9b and K9c run once a window batch; each batch ends in one chain, each
    # of the five MSMs in one more (the fold)
    batches = 5 * (sum(t for _, t in chains) - 1)
    log(f"jacobian prove: K9b launches {launches['ec_block_totals_madd']} ({ordered} through "
        f"an order), K9c {launches['ec_block_totals_add']}, window batches {batches}")
    if not (launches["ec_block_totals_madd"] == launches["ec_block_totals_add"] == ordered
            == batches):
        raise AssertionError("the Jacobian prove did not launch K9b through an order and K9c "
                             "once a window batch")
    if traced:
        raise AssertionError("the Jacobian prove's trace holds the sorted copy of the leaves")
    most = {"ec_add": 5 * sum(t for _, t in adds), "ec_add_chain": 5 * sum(t for _, t in chains)}
    log(f"jacobian prove: K8 launches {launches['ec_add']} (at most {most['ec_add']}), "
        f"chain launches {launches['ec_add_chain']} (at most {most['ec_add_chain']})")
    over = [k for k, m in most.items() if launches[k] > m]
    if over:
        raise AssertionError(f"the Jacobian prove launched more than k8_shapes allows: {over}")
    want = run["proof"]
    if (proof.a, proof.b, proof.c) != (want.a, want.b, want.c):
        raise AssertionError("the Jacobian engine's proof != the RCB engine's")
    log("jacobian prove: the proof equals the RCB engine's for the same (r, s)")
    check_verdicts(curve, params, shape, proof)
    return {"setup_launches": setup_launches, "prove_launches": launches}


TRACE_LOG2 = 15  # the smallest square chain whose Jacobian MSMs take K9b's order path


def trace_window_sums(card: str, curve, run: dict) -> int:
    """Sets up (on the engine in force) and proves the 2^TRACE_LOG2 square
    chain, the prove traced with Python stacks (`profile_prove.
    row_read_origins`; the trace's cost grows with the ops, not their
    size), and returns the row reads that an `aten::index` op launched
    from `_window_sums` (its own frame or a generator in it). Its digits'
    sort, gather and bucket range are no leaf rows; the sorted copy of the
    leaves was three such ops a window batch (X, Y, flags), one K9b launch.
    Fails unless every K9b launch of that prove came through an order."""
    import torch

    from ckb_zkp_tpu_torch.bench_circuits import square_chain_shape
    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.profile_prove import row_read_origins
    from ckb_zkp_tpu_torch.schemes import groth16

    shape = square_chain_shape((1 << TRACE_LOG2) - 2, curve.fr.modulus, seed=SEED % 1000)
    params = groth16.generate_parameters_from_shape(shape, curve, *run["toxic"], device=DEVICE)
    torch.cuda.synchronize()
    cuda_build.reset_counts()
    t0 = time.perf_counter()
    origins = row_read_origins(lambda st: groth16.create_proof_from_shape(
        params, shape, run["r"], run["s"]))
    traced_s = time.perf_counter() - t0
    k9b, ordered = cuda_build.COUNTS["ec_block_totals_madd"], cuda_build.ORDERED[
        "ec_block_totals_madd"]
    own = {where: n for where, (n, _) in origins.items()
           if any(f.endswith(": _window_sums")
                  for f in where.split(" @ ")[1].split(" < ")[:2])}
    copies = sum(n for where, n in own.items() if where.startswith("aten::index @"))
    log(f"jacobian prove of 2^{TRACE_LOG2} under the profiler with stacks ({traced_s:.3f} "
        f"s): K9b launches {k9b} ({ordered} through an order), row reads "
        f"{sum(n for n, _ in origins.values())}, "
        f"{sum(ms for _, ms in origins.values()):.3f} ms; launched by _window_sums "
        f"{sum(own.values())}, of them by aten::index {copies} (the sorted copy: {3 * k9b}; "
        f"now 0) [{card}]")
    if not 0 < k9b == ordered:
        raise AssertionError(f"the traced 2^{TRACE_LOG2} Jacobian prove did not launch K9b "
                             "through an order")
    return copies


def phase_jacobian_leaf(card: str) -> dict:
    """The Jacobian MSM that still runs the elementwise K9a: G1 and G2 at
    `leaf_shapes`' width through the device group's `msm`, on the Jacobian
    engine at its 2^20 thresholds, each held against the host ints. The
    points repeat 16 host points (one at infinity) under random scalars,
    so the host sum is 16 scalar multiples. The counts are set to 0 just
    before the two MSMs and read just after: `ec_madd` must run exactly as
    often as `leaf_shapes` counts."""
    import torch

    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.ops.msm import device_group

    curve = get_curve("bn254")
    r = curve.fr.modulus
    n, _, per_msm = leaf_shapes()
    prng = random.Random(SEED + 1)
    runs = []
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        host = dg.host_group
        gen = curve.g1_gen if group == "g1" else curve.g2_gen
        base = [host.mul(gen, prng.randrange(1, r)) for _ in range(15)] + [host.infinity]
        sc = [prng.randrange(r) for _ in range(n)]
        sc[5] = 0
        want = host.infinity
        for j, b in enumerate(base):
            want = host.add(want, host.mul(b, sum(sc[j::16]) % r))
        idx = torch.arange(n, device=DEVICE) % 16
        P = tuple(c[idx] for c in dg.encode_points(base))
        runs.append((group, dg, P, dg.encode_scalars(sc), want))
    with jacobian_engine(curve):
        torch.cuda.synchronize()
        cuda_build.reset_counts()
        t0 = time.perf_counter()
        outs = [dg.msm(P, S) for _, dg, P, S, _ in runs]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(cuda_build.COUNTS)
    for (group, dg, _, _, want), out in zip(runs, outs):
        if dg.decode_point(out) != want:
            raise AssertionError(f"Jacobian MSM at {n} points != host ints ({group})")
    log(f"jacobian msm at {n} points (the leaf branch), G1 and G2: {secs:.6f} s, equal to "
        f"the host ints; launches {json.dumps(launches)} [{card}]")
    if launches["ec_madd"] != 2 * per_msm:
        raise AssertionError(f"the {n}-point Jacobian MSMs launched the elementwise K9a "
                             f"{launches['ec_madd']} times, not {2 * per_msm}")
    return launches


# The sharded prove (`ckb_zkp_tpu_torch/parallel/`): the kernels every rank
# must launch (K1, K2, K4, K5; K3 only where block totals pass _TOP_MAX),
# (p2)'s ranks, which share the one card over gloo, and (p3)'s MSM width
PARALLEL_NEEDS = ("mont_mul", "scan_prefix_madd", "scan_total_add", "rcb_add")
PARALLEL_RANKS = 2
PARALLEL_WIDE_LOG2 = 16
PARALLEL_TIMEOUT_S = 600


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_prove(card: str, mesh, params, shape, r: int, s: int, label: str) -> dict:
    """One `create_proof_from_shape(..., mesh=)` with the counts set to 0
    just before it and read just after: its seconds, stages (collectives
    apart), collective seconds and calls, launches, peak and held device
    memory, and the proof's points."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.schemes import groth16

    torch.cuda.synchronize()
    before = dict(mesh.stats)
    cuda_build.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    stages: dict = {}
    t0 = time.perf_counter()
    proof = groth16.create_proof_from_shape(params, shape, r, s, timings=stages, mesh=mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(cuda_build.COUNTS)
    out = {"rank": mesh.rank, "ranks": mesh.size, "seconds": round(secs, 6),
           "stages": {k: round(v, 6) for k, v in stages.items()},
           "collective_s": round(mesh.stats["seconds"] - before["seconds"], 6),
           "collective_calls": mesh.stats["calls"] - before["calls"],
           "collective_bytes": mesh.stats["bytes"] - before["bytes"],
           "launches": {k: v for k, v in launches.items() if v},
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "held_bytes": torch.cuda.memory_allocated(),
           "proof": [[p.x, p.y] if not p.infinity else None
                     for p in (proof.a, proof.b, proof.c)]}
    log(f"sharded prove {label}, rank {mesh.rank} of {mesh.size}: {secs:.3f} s, collectives "
        f"{out['collective_s']:.3f} s in {out['collective_calls']} calls "
        f"({out['collective_bytes']} bytes), peak device memory {out['peak_bytes']} bytes, "
        f"held {out['held_bytes']} [{card}]")
    log(f"sharded prove {label}, rank {mesh.rank}: stages {json.dumps(out['stages'])}; "
        f"launches {json.dumps(out['launches'])} (K3 {launches['scan_prefix_add']})")
    missing = [k for k in PARALLEL_NEEDS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the sharded prove ({label}, rank {mesh.rank}) did not launch "
                             f"{missing}")
    out["proof_obj"] = proof
    return out


def _same_proof(got: dict, want, label: str) -> None:
    pts = [[p.x, p.y] if not p.infinity else None for p in (want.a, want.b, want.c)]
    if json.loads(json.dumps(got["proof"])) != json.loads(json.dumps(pts)):
        raise AssertionError(f"the sharded proof ({label}, rank {got['rank']}) != the "
                             "single-device proof")


def parallel_rank(card: str, port: int, rank: int, world: int, log2: int) -> dict:
    """(p2)'s rank: joins a gloo world of `world` ranks on the one card,
    synthesizes phase_slice's square chain, runs its setup from the same
    toxic waste, and proves it sharded with the same (r, s); rank 0 also
    checks the verifier's verdicts. Returns `sharded_prove`'s record."""
    import torch
    import torch.distributed as dist

    from ckb_zkp_tpu_torch.bench_circuits import square_chain_shape
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.parallel import global_mesh, init_multihost
    from ckb_zkp_tpu_torch.schemes import groth16

    cuda_build.lib()
    init_multihost(f"localhost:{port}", world, rank, "gloo", device=DEVICE,
                   timeout_s=PARALLEL_TIMEOUT_S)
    try:
        mesh = global_mesh()
        curve = get_curve("bn254")
        fr = curve.fr.modulus
        prng = random.Random(SEED)  # phase_slice's sequence: toxic waste, then r, s
        t0 = time.perf_counter()
        shape = square_chain_shape((1 << log2) - 2, fr, seed=SEED % 1000)
        synth_s = time.perf_counter() - t0
        toxic = [prng.randrange(1, fr) for _ in range(5)]
        t0 = time.perf_counter()
        params = groth16.generate_parameters_from_shape(shape, curve, *toxic, device=DEVICE)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        log(f"parallel rank {rank}: synthesis {synth_s:.3f} s, setup {setup_s:.3f} s [{card}]")
        r, s = prng.randrange(1, fr), prng.randrange(1, fr)
        out = sharded_prove(card, mesh, params, shape, r, s, f"(p2) 2^{log2}")
        if rank == 0:
            check_verdicts(curve, params, shape, out["proof_obj"])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    out.pop("proof_obj")
    return out | {"synthesis_s": round(synth_s, 6), "setup_s": round(setup_s, 6)}


def start_parallel_rank(card: str, port: int, rank: int, log2: int):
    import subprocess

    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "print(json.dumps(chip_smoke.parallel_rank(sys.argv[2], *map(int, sys.argv[3:]))))")
    return subprocess.Popen([sys.executable, "-c", code, REPO, card, str(port), str(rank),
                             str(PARALLEL_RANKS), str(log2)], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_parallel_ranks(children: list) -> list:
    """Relays each rank's lines and reads its record; a rank that fails or
    outlives PARALLEL_TIMEOUT_S fails the phase with its stderr's tail (the
    others are killed, so none waits in a collective)."""
    import subprocess

    outs = []
    try:
        for rank, child in enumerate(children):
            try:
                out, err = child.communicate(timeout=PARALLEL_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                child.kill()
                out, err = child.communicate()
                raise AssertionError(f"(p2) rank {rank} timed out: {err[-3000:]}")
            lines = out.strip().splitlines()
            for line in lines[:-1]:
                log(line)
            if child.returncode != 0 or not lines:
                raise AssertionError(f"(p2) rank {rank} failed: {err[-3000:]}")
            outs.append(json.loads(lines[-1]))
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    return outs


def wide_sharded_msms(card: str, mesh) -> dict:
    """(p3): a BLS12-381 G1 and G2 msm_sharded of 2^PARALLEL_WIDE_LOG2
    points on `mesh`, each equal to the host ints (16 host points repeated
    under random scalars, so the host sum is 16 scalar multiples), with
    the 12-word launches of each (`cuda_build.WIDE`), which must cover
    those of the single-device MSM of the same input; then the fold of two
    partials, which must run K5's 12-word instance and not K8 (which has
    no 12-word instance)."""
    import torch

    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.ops.msm import device_group
    from ckb_zkp_tpu_torch.parallel import msm_sharded
    from ckb_zkp_tpu_torch.parallel.msm import fold

    curve = get_curve("bls12_381")
    r = curve.fr.modulus
    n = 1 << PARALLEL_WIDE_LOG2
    prng = random.Random(SEED + 3)
    out = {}
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        host = dg.host_group
        gen = curve.g1_gen if group == "g1" else curve.g2_gen
        base = [host.mul(gen, prng.randrange(1, r)) for _ in range(15)] + [host.infinity]
        sc = [prng.randrange(r) for _ in range(n)]
        want = host.infinity
        for j, b in enumerate(base):
            want = host.add(want, host.mul(b, sum(sc[j::16]) % r))
        idx = torch.arange(n, device=DEVICE) % 16
        P = tuple(c[idx] for c in dg.encode_points(base))
        S = dg.encode_scalars(sc)
        cuda_build.reset_counts()
        single = dg.msm(P, S)
        torch.cuda.synchronize()
        single_wide = {k: v for k, v in cuda_build.WIDE.items() if v}
        cuda_build.reset_counts()
        t0 = time.perf_counter()
        got = msm_sharded(dg, P, S, mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        wide = {k: v for k, v in cuda_build.WIDE.items() if v}
        if dg.decode_point(got) != want or dg.decode_point(single) != want:
            raise AssertionError(f"(p3) BLS12-381 {group} msm_sharded at {n} points != host ints")
        if not wide or not set(single_wide) <= set(wide):
            raise AssertionError(f"(p3) {group}: the sharded MSM's 12-word launches {wide} do "
                                 f"not cover the single-device MSM's {single_wide}")
        cuda_build.reset_counts()
        twice = fold(dg, tuple(torch.stack([c, c]) for c in got))
        torch.cuda.synchronize()
        fold_wide, fold_k8 = cuda_build.WIDE["rcb_add"], cuda_build.COUNTS["ec_add"]
        if dg.decode_point(twice) != host.add(want, want) or fold_wide <= 0 or fold_k8:
            raise AssertionError(f"(p3) {group}: the fold of two partials is wrong or did not "
                                 f"run the 12-word K5 (K5w {fold_wide}, K8 {fold_k8})")
        log(f"(p3) BLS12-381 {group} msm_sharded, {n} points, 1 rank: {secs:.6f} s, equal to "
            f"the host ints; 12-word launches {json.dumps(wide)} (single-device "
            f"{json.dumps(single_wide)}); the fold of two partials: K5w {fold_wide}, K8 "
            f"{fold_k8} [{card}]")
        out[group] = {"seconds": round(secs, 6), "wide": wide, "fold_rcb_add_nw12": fold_wide}
    return out


def phase_parallel(card: str, run: dict, log2: int) -> dict:
    """The sharded prove on the one card (`ckb_zkp_tpu_torch/parallel/`):
    (p1) one rank over NCCL in this process proves phase_slice's 2^log2
    square chain with `mesh=` (the sharded domain at d = 1, the sharded
    MSMs), equal point for point to `run["proof"]`, launching K1, K2, K4
    and K5; (p3) on that rank, `wide_sharded_msms`; (p2) PARALLEL_RANKS
    ranks in child processes on this one card over gloo (NCCL refuses two
    ranks on one device), each with its own synthesis and setup from the
    same toxic waste, each proof equal to `run["proof"]`, each rank
    launching K1, K2, K4 and K5. Several cards are not run here: the
    script needs one card."""
    import torch
    import torch.distributed as dist

    from ckb_zkp_tpu_torch.parallel import global_mesh, init_multihost

    t0 = time.perf_counter()
    init_multihost(f"localhost:{free_port()}", 1, 0, "nccl", device=DEVICE,
                   timeout_s=PARALLEL_TIMEOUT_S)
    try:
        mesh = global_mesh()
        p1 = sharded_prove(card, mesh, run["params"], run["shape"], run["r"], run["s"],
                           f"(p1) 2^{log2}")
        _same_proof(p1, run["proof"], "(p1)")
        log(f"(p1) the sharded proof equals the single-device proof [{card}]")
        p3 = wide_sharded_msms(card, mesh)
        del mesh  # with it its sharded domain's twiddle and coset blocks
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    port = free_port()
    children = [start_parallel_rank(card, port, rank, log2) for rank in range(PARALLEL_RANKS)]
    p2 = finish_parallel_ranks(children)
    for out in p2:
        _same_proof(out, run["proof"], "(p2)")
    log(f"(p2) {PARALLEL_RANKS} ranks on one card over gloo: every rank's proof equals the "
        f"single-device proof; rank seconds {[o['seconds'] for o in p2]}, collective seconds "
        f"{[o['collective_s'] for o in p2]}, peak bytes {[o['peak_bytes'] for o in p2]} [{card}]")
    t2 = time.perf_counter()
    p1.pop("proof_obj")
    return {"p1": p1, "p2": p2, "p3": p3,
            "seconds": {"p1_p3": round(t1 - t0, 3), "p2": round(t2 - t1, 3)}}


# The 12-word instances of K1-K6 (BLS12-381's Fq and Fq2): a row each in
# the kernel table, beside the 8-word rows, with launches from the
# BLS12-381 slice (`cuda_build.WIDE`)
WIDE_ROWS = {f"{k}_nw12": k for k in ("mont_mul", "scan_prefix_madd", "scan_prefix_add",
                                      "scan_total_add", "rcb_add", "rcb_fixed_base")}
# at the setup's width, plain K6 at 12 words runs on this many leading
# points only (the whole 2^20 G2 plain version takes about a minute)
WIDE_FB_PLAIN_ROWS = 1 << 16


def phase_wide_kernels(results: dict, log2: int) -> tuple:
    """BLS12-381's 12-word K1-K6 against their plain versions, bit for bit:
    K1 on Fq at 2^16 elements with 0, 1, p - 1 and R mod p, then at the
    setup's normalization width (2^log2 Fq rows); K5 at 2^14 G1 and G2
    points with P + P, P + (-P) and identity operands, also against the
    host group; K6's fixed-base kernel, K2 and K5 (`team_checks`), K3 and
    K4 (`scan_level_checks`) at their edge shapes and at the shapes of a
    2^log2 BLS12-381 setup and prove (K6's plain version on the first
    WIDE_FB_PLAIN_ROWS points at the setup's width); then the port's G1
    and G2 MSM against the host-int MSM, and the Jacobian engine's refusal
    at 12 words. Rows are recorded as "<kernel>_nw12"."""
    import numpy as np
    import torch

    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.ops.msm import device_group

    rng = np.random.default_rng(SEED + 12)
    curve = get_curve("bls12_381")
    rec = Recorder(results)

    def record(name, *args, **kw):
        rec(name + "_nw12", *args, **kw)

    df = device_group(curve, "g1", DEVICE).fq
    before = cuda_build.WIDE["mont_mul"]
    mul_edge_check(record, rng, df, "bls12_381 fq")
    if cuda_build.WIDE["mont_mul"] <= before:
        raise AssertionError("BLS12-381 Fq's K1 did not launch the 12-word instance")
    n = 1 << log2
    a = rand_field(rng, n, (df.L,), df)
    b = rand_field(rng, n, (df.L,), df)
    pl, plain_ms = timed_once(lambda: df.plain.mul(a, b))
    record("mont_mul", max_abs_err(df.mul(a, b), pl), cuda_ms(lambda: df.mul(a, b), 10),
           plain_ms, f"bls12_381 fq n={n} a*b (the setup's normalization); main path",
           (3 * n * fq_bytes(df.L), n * imad_per_mul(df.L)))
    del a, b
    add_edge_checks(record, rng, curve, madd=False)
    torch.cuda.empty_cache()
    fixed, _ = fixed_base_checks(record, rng, curve, log2, plain_rows=WIDE_FB_PLAIN_ROWS)
    torch.cuda.empty_cache()
    team = team_checks(record, rng, curve, log2)
    levels = scan_level_checks(record, rng, curve, log2)
    torch.cuda.empty_cache()

    prng = random.Random(SEED + 12)
    for group, n in (("g1", 700), ("g2", 300)):
        dg = device_group(curve, group, DEVICE)
        host = dg.host_group
        gen = curve.g1_gen if group == "g1" else curve.g2_gen
        base = [host.mul(gen, prng.randrange(1, curve.fr.modulus)) for _ in range(16)]
        pts = [base[i % 16] for i in range(n)]
        pts[3] = host.infinity
        sc = [prng.randrange(curve.fr.modulus) for _ in range(n)]
        sc[5] = 0
        P, S = dg.encode_points(pts), dg.encode_scalars(sc)
        if dg.decode_point(dg.msm(P, S)) != host.msm(pts, sc):
            raise AssertionError(f"port MSM != host MSM (bls12_381 {group}, n={n})")
        log(f"msm bls12_381 {group} n={n}: equal to the host-int MSM")
        with jacobian_engine(curve):
            try:
                dg.msm(P, S)
            except RuntimeError as e:
                log(f"msm bls12_381 {group} on the Jacobian engine refused: {e}")
            else:
                raise AssertionError("a 12-word Jacobian MSM ran: it has no 12-word kernel")
    return levels, team, fixed


def phase_wide_frontends(card: str) -> None:
    """BLS12-381 through the reference's front ends on the card: the Mini
    circuit's `generate_random_parameters`, then `create_random_proof` and
    `create_proof_no_zk`; each proof verifies and the wrong public input
    is refused."""
    from ckb_zkp_tpu_torch.circuits import Mini
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.schemes import groth16

    curve = get_curve("bls12_381")
    rng = random.Random(SEED + 2)
    t0 = time.perf_counter()
    params = groth16.generate_random_parameters(Mini.power_off(), curve, rng, device=DEVICE)
    circuit = Mini.power_on(2, 3, 10)
    pvk = groth16.prepare_verifying_key(curve, params.vk)
    for proof in (groth16.create_random_proof(params, circuit, rng),
                  groth16.create_proof_no_zk(params, circuit)):
        ok = groth16.verify_proof(curve, pvk, proof, [10])
        bad = groth16.verify_proof(curve, pvk, proof, [11])
        if ok is not True or bad is not False:
            raise AssertionError("a Mini proof on BLS12-381 does not verify, or a wrong "
                                 "public input does")
    log(f"front ends bls12_381: Mini set up, proved (random and no-zk) and verified, "
        f"wrong public input refused, {time.perf_counter() - t0:.3f} s [{card}]")


def phase_wide_bytes(card: str, run: dict) -> dict:
    """The keys of a BLS12-381 setup check (`run`) through
    `parameters_to_bytes` and `parameters_from_bytes` (the padded layout on
    the card), a prove with the decoded keys equal to one with the
    original keys for the same (r, s), and the proof and verifying key
    through their codecs. Returns the seconds of each step."""
    import torch

    from ckb_zkp_tpu_torch.schemes import groth16
    from ckb_zkp_tpu_torch.schemes.groth16 import serialize

    curve, shape, params = run["curve"], run["shape"], run["params"]
    secs: dict = {}
    t0 = time.perf_counter()
    data = serialize.parameters_to_bytes(params)
    secs["parameters_to_bytes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = serialize.parameters_from_bytes(curve, data, DEVICE)
    torch.cuda.synchronize()
    secs["parameters_from_bytes"] = time.perf_counter() - t0
    if back.vk != params.vk or not back.padded_queries:
        raise AssertionError("decoded BLS12-381 keys: another verifying key or layout")
    r, s = 5, 6
    want = groth16.create_proof_from_shape(params, shape, r, s)
    t0 = time.perf_counter()
    got = groth16.create_proof_from_shape(back, shape, r, s)
    secs["prove_decoded_keys"] = time.perf_counter() - t0
    if (got.a, got.b, got.c) != (want.a, want.b, want.c):
        raise AssertionError("the decoded BLS12-381 keys prove another proof")
    pb = serialize.proof_to_bytes(curve, got)
    back_proof = serialize.proof_from_bytes(curve, pb)
    vb = serialize.vk_to_bytes(curve, params.vk)
    if ((back_proof.a, back_proof.b, back_proof.c) != (got.a, got.b, got.c)
            or serialize.vk_from_bytes(curve, vb) != params.vk):
        raise AssertionError("the BLS12-381 proof or verifying key codec does not round trip")
    log(f"bytes bls12_381 2^{shape.num_variables.bit_length() - 1}: {len(data)} B of keys, "
        f"{len(pb)} B a proof, {len(vb)} B of vk; the decoded keys prove the same proof; "
        f"seconds {json.dumps(secs)} [{card}]")
    return secs


def phase_wide(results: dict, card: str, log2: int) -> dict:
    """The BLS12-381 phase: the 12-word kernels (`phase_wide_kernels`), the
    2^min(12, log2) device setup against host mode (`phase_setup_check`;
    2^12 since the Spartan phase came: at 2^14 its keys' host decode took
    78-99 s beside an NVIDIA H100 80GB HBM3, 700.00 W),
    the 2^log2 slice's setup, proves and verdicts (`phase_slice`), the
    front ends on Mini and the key, proof and vk bytes of the setup
    check's keys. Returns the slice's run with each part's seconds."""
    import torch

    marks = [time.perf_counter()]
    levels, team, fixed = phase_wide_kernels(results, log2)
    log(f"scan levels bls12_381 (K3, K4 at 12 words, 2^{log2}, {card}): "
        f"{json.dumps(levels)}")
    log(f"team shapes bls12_381 (K2, K5 at 12 words, 2^{log2}, {card}): {json.dumps(team)}")
    log(f"fixed base bls12_381 (K6 at 12 words, 2^{log2}, {card}): {json.dumps(fixed)}")
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    check = phase_setup_check(min(12, log2), "bls12_381")
    marks.append(time.perf_counter())
    run = phase_slice(card, log2, "bls12_381")
    del run["params"]
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    phase_wide_frontends(card)
    marks.append(time.perf_counter())
    run["bytes_s"] = phase_wide_bytes(card, check)
    marks.append(time.perf_counter())
    run["seconds"] = dict(zip(("kernels", "setup_check", "slice", "front_ends", "bytes"),
                              (b - a for a, b in zip(marks, marks[1:]))))
    log(f"bls12_381 phase seconds: {json.dumps(run['seconds'])} [{card}]")
    return run


# ---------------------------------------------------------------- Marlin
MARLIN_LOG2 = 15  # |H| = 2^15: square chain of 2^15 - 2 constraints, SRS 2^17 + 1 (2^16
# until the sharded prove's phase came: cut to keep the smoke within its time limit)
MARLIN_KERNELS = ("mont_mul", "scan_prefix_madd", "scan_prefix_add", "scan_total_add",
                  "rcb_add", "rcb_fixed_base")  # K1-K6, 8 words on BN254
KZG_WIDE_LOG2 = 12  # the BLS12-381 KZG10 round trip's degree


class SquareChain:
    """x_i * x_i = x_(i+1) for i < n, x_n the one public input: the shape of
    `bench_circuits.square_chain_shape` as a ConstraintSynthesizer (the
    smoke's own Marlin and Spartan circuit). n + 2 variables (ONE, x_n,
    x_0..x_(n-1)); x0 None synthesizes without values (the indexer's mode)."""

    def __init__(self, n: int, p: int, x0: int | None = None):
        self.n, self.p, self.x0 = n, p, x0

    def chain(self) -> list:
        xs = [self.x0]
        for _ in range(self.n):
            xs.append(None if xs[-1] is None else xs[-1] * xs[-1] % self.p)
        return xs

    def generate_constraints(self, cs) -> None:
        xs = self.chain()
        aux = [cs.alloc(f"x{i}", xs[i]) for i in range(self.n)]
        out = cs.alloc_input("x_n", xs[self.n])
        for i in range(self.n):
            cs.enforce("x_i * x_i = x_(i+1)", aux[i], aux[i], aux[i + 1] if i + 1 < self.n else out)


def mini_proof(device: str) -> dict:
    """The Mini circuit's Marlin proof over BN254 as `tests/test_marlin.py`
    seeds it (`random.Random(123)`, SRS degree 128), on `device`, as
    JSON-able fields: the verifying key's bytes (hex), the commitments,
    evaluations and opening proofs."""
    from ckb_zkp_tpu_torch.circuits import Mini
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.schemes import marlin

    pt = lambda q: None if q is None else [q.infinity, q.x, q.y]  # noqa: E731
    rng = random.Random(123)
    srs = marlin.universal_setup(get_curve("bn254"), 128, rng, device=device)
    ipk, ivk = marlin.index(srs, Mini.power_off())
    proof = marlin.create_random_proof(ipk, Mini.power_on(2, 3, 10), rng)
    if not marlin.verify_proof(ivk, proof, [10]) or marlin.verify_proof(ivk, proof, [11]):
        raise AssertionError(f"the Mini proof on {device} does not verify, or [11] does")
    return {"ivk": ivk.to_bytes().hex(),
            "commitments": [[[pt(c.comm), pt(c.shifted_comm)] for c in r]
                            for r in proof.commitments],
            "evaluations": proof.evaluations,
            "openings": [[pt(o.w), o.rand_v] for o in proof.opening_proofs]}


def start_mini_cpu():
    """The Mini Marlin proof and the reference PLONK proof
    (`plonk_reference_proof`) from the plain versions on the host's CPU, in
    a child process (its torch on 2 threads) started after the timed kernel
    rows, so that none of them is timed beside it; it runs while the
    Groth16 phases use the card. `finish_mini_cpu` reads them:
    {"marlin": ..., "plonk": ...}."""
    import subprocess

    code = ("import json, sys, torch; torch.set_num_threads(2); sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; print(json.dumps({'marlin': chip_smoke.mini_proof('cpu'), "
            "'plonk': chip_smoke.plonk_reference_proof('cpu')}))")
    return subprocess.Popen([sys.executable, "-c", code, REPO], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_mini_cpu(child) -> dict:
    out, err = child.communicate(timeout=600)
    if child.returncode != 0:
        raise AssertionError(f"a Mini proof child failed: {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


class TransformClock:
    """Seconds the AHP spends in the device branch of `HDomain` (upload,
    NTT, download) and in its two device products (`ahp._poly_mul`),
    each call closed by a synchronize; installed for one phase."""

    def __init__(self):
        self.seconds = {"hdomain": 0.0, "poly_mul": 0.0}
        self.calls = {"hdomain": 0, "poly_mul": 0}

    def _wrap(self, key, fn):
        import torch

        def timed(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.seconds[key] += time.perf_counter() - t0
            self.calls[key] += 1
            return out
        return timed

    @contextlib.contextmanager
    def installed(self):
        from ckb_zkp_tpu_torch.ops.hdomain import HDomain
        from ckb_zkp_tpu_torch.schemes.marlin import ahp

        saved = (HDomain._device, ahp._poly_mul)
        HDomain._device = self._wrap("hdomain", saved[0])
        ahp._poly_mul = self._wrap("poly_mul", saved[1])
        try:
            yield self
        finally:
            HDomain._device, ahp._poly_mul = saved

    def take(self) -> dict:
        out = {k: round(v, 6) for k, v in self.seconds.items()} | {
            f"{k}_calls": v for k, v in self.calls.items()}
        self.seconds = dict.fromkeys(self.seconds, 0.0)
        self.calls = dict.fromkeys(self.calls, 0)
        return out


@contextlib.contextmanager
def divisions_recorded():
    """Records (n, K1 launches, df, coeffs, z) of each `poly_divide_linear`
    call that `marlin/pc.py` makes while the context is open."""
    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.schemes.marlin import pc

    seen: list = []
    real = pc.poly_divide_linear

    def rec(df, coeffs, z):
        k1 = cuda_build.COUNTS["mont_mul"]
        out = real(df, coeffs, z)
        seen.append((coeffs.shape[0], cuda_build.COUNTS["mont_mul"] - k1, df, coeffs, z))
        return out

    pc.poly_divide_linear = rec
    try:
        yield seen
    finally:
        pc.poly_divide_linear = real


def profiled(run, top: int = 8) -> dict:
    """One run under the torch profiler (CUDA activity): its wall seconds,
    the device busy seconds (the sum of its kernels' times), the idle
    share, the kernel launches, and the `top` kernels by device ms."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    by_name: dict = {}
    for e in kernels:
        k, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (k + 1, ms + e.time_range.elapsed_us() / 1e3)
    tops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_s": wall, "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
            "kernel_launches": len(kernels),
            "top_kernels": [[name[:60], k, round(ms, 3)] for name, (k, ms) in tops]}


def division_launches(df, coeffs, z) -> dict:
    """Every CUDA kernel that one `poly_divide_linear` of `coeffs` launches
    (the torch profiler's kernel events), with K1's share."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.ops.poly import poly_divide_linear

    torch.cuda.synchronize()
    k1 = cuda_build.COUNTS["mont_mul"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        poly_divide_linear(df, coeffs, z)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"n": coeffs.shape[0], "k1_launches": cuda_build.COUNTS["mont_mul"] - k1,
            "kernel_launches": len(kernels),
            "rounds": (coeffs.shape[0] - 1).bit_length()}


def phase_marlin(card: str, log2: int = MARLIN_LOG2) -> dict:
    """Marlin over BN254 on the card: `universal_setup` (K6 twice, K1),
    `index` and `create_random_proof` of the (2^log2 - 2)-constraint square
    chain (K1-K5), each stage timed (the AHP's device transforms apart from
    its host work), `verify_proof` on the public input and on a changed
    one; every kernel of K1-K6 launched by the phase; the launches of the
    largest opening's synthetic division (O(log n)). Returns the phase's
    launches, seconds and the division's launches."""
    import torch

    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.schemes import marlin
    from ckb_zkp_tpu_torch.schemes.marlin import ahp

    curve = get_curve("bn254")
    p = curve.fr.modulus
    n = (1 << log2) - 2
    rng = random.Random(SEED + 13)
    x0 = rng.randrange(2, p)
    max_degree = ahp.max_degree(n + 2, n + 2, n)
    secs: dict = {}
    clock = TransformClock()
    torch.cuda.synchronize()
    cuda_build.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srs = marlin.universal_setup(curve, max_degree, rng, device=DEVICE)
    torch.cuda.synchronize()
    secs["universal_setup"] = time.perf_counter() - t0
    log(f"marlin setup: max_degree {max_degree}, {srs.max_degree + 1} powers, "
        f"{secs['universal_setup']:.3f} s; launches {json.dumps(cuda_build.COUNTS)} [{card}]")
    with clock.installed():
        index_t: dict = {}
        t0 = time.perf_counter()
        ipk, ivk = marlin.index(srs, SquareChain(n, p), timings=index_t)
        secs["index"] = time.perf_counter() - t0
        index_dev = clock.take()
        info = ivk.index_info
        log(f"marlin index: {info.num_constraints} constraints, {info.num_variables} "
            f"variables, {info.num_non_zeros} non-zeros, {secs['index']:.3f} s "
            f"{json.dumps(index_t)}; AHP device transforms {json.dumps(index_dev)} [{card}]")
        prove_t: dict = {}
        with divisions_recorded() as divs:
            t0 = time.perf_counter()
            proof = marlin.create_random_proof(ipk, SquareChain(n, p, x0), rng, prove_t)
            secs["create_random_proof"] = time.perf_counter() - t0
        prove_dev = clock.take()
    log(f"marlin prove: {secs['create_random_proof']:.3f} s {json.dumps(prove_t)}; AHP "
        f"device transforms {json.dumps(prove_dev)} [{card}]")
    public = SquareChain(n, p, x0).chain()[-1]
    t0 = time.perf_counter()
    ok = marlin.verify_proof(ivk, proof, [public])
    secs["verify_proof"] = time.perf_counter() - t0
    bad = marlin.verify_proof(ivk, proof, [(public + 1) % p])
    launches = {k: cuda_build.COUNTS[k] for k in MARLIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    log(f"marlin verify_proof: {ok} in {secs['verify_proof']:.3f} s; changed public input: "
        f"{bad}")
    if ok is not True or bad is not False:
        raise AssertionError("the Marlin proof does not verify, or one with a changed public "
                             "input does")
    log(f"marlin launches (setup to verify): {json.dumps(cuda_build.COUNTS)}; peak device "
        f"memory {peak} bytes [{card}]")
    missing = [k for k in MARLIN_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the Marlin phase: {missing}")
    warm_t: dict = {}
    prof = profiled(lambda: marlin.create_random_proof(
        ipk, SquareChain(n, p, x0), random.Random(SEED + 15), warm_t))
    log(f"marlin prove, warm, profiled: {json.dumps(prof)}; stages {json.dumps(warm_t)} "
        f"[{card}]")
    largest = max(divs, key=lambda d: d[0])
    div = division_launches(*largest[2:])
    div["k1_launches_in_prove"] = largest[1]
    log(f"marlin openings: synthetic divisions of {[d[0] for d in divs]} coefficients; the "
        f"largest: {json.dumps(div)}")
    if div["k1_launches"] != div["rounds"] or div["kernel_launches"] > 40 * div["rounds"]:
        raise AssertionError("the opening's synthetic division does not run in O(log n) "
                             "launches")
    return {"launches": launches, "seconds": secs, "index_stages": index_t,
            "prove_stages": prove_t, "index_device": index_dev, "prove_device": prove_dev,
            "division": div, "peak_bytes": peak, "warm": prof, "warm_stages": warm_t}


def phase_marlin_mini(card: str, cpu_child) -> dict:
    """The Mini proof on the card against the port's CPU proof from the
    plain versions (computed by `cpu_child`), field for field. Returns the
    child's proofs (the PLONK one is `phase_plonk_reference`'s)."""
    t0 = time.perf_counter()
    got = mini_proof(DEVICE)
    card_s = time.perf_counter() - t0
    want = finish_mini_cpu(cpu_child)
    if got != want["marlin"]:
        raise AssertionError("the Mini Marlin proof on the card differs from the CPU one")
    log(f"marlin mini: the proof and vk bytes on the card ({card_s:.3f} s) equal the port's "
        f"CPU proof from the plain versions; both verify, [11] refused [{card}]")
    return want


def phase_kzg_wide(card: str, log2: int = KZG_WIDE_LOG2) -> dict:
    """A KZG10 round trip over BLS12-381 at degree 2^log2, without hiding
    and with a hiding bound of 2: setup (the 12-word K6, K1), commit and
    open (the 12-word K2-K5) and `check` on the true and a wrong value.
    Returns the 12-word launches (`cuda_build.WIDE`); fails unless every
    12-word K1-K6 ran."""
    import torch

    from ckb_zkp_tpu_torch.host import poly as hpoly
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.ops.field import device_field
    from ckb_zkp_tpu_torch.schemes import kzg10

    curve = get_curve("bls12_381")
    p = curve.fr.modulus
    rng = random.Random(SEED + 14)
    torch.cuda.synchronize()
    cuda_build.reset_counts()
    t0 = time.perf_counter()
    pp = kzg10.setup(curve, 1 << log2, rng, device=DEVICE)
    ck, vk = kzg10.trim(pp, 1 << log2)
    fr = device_field(curve.fr, DEVICE)
    coeffs = [rng.randrange(p) for _ in range((1 << log2) + 1)]
    point = rng.randrange(p)
    value = hpoly.evaluate(coeffs, point, p)
    for hiding in (None, 2):
        cdev = fr.encode(coeffs)
        comm, rand = kzg10.commit(ck, cdev, hiding, rng)
        proof = kzg10.open_at(ck, cdev, point, rand)
        ok = kzg10.check(vk, comm, point, value, proof)
        bad = kzg10.check(vk, comm, point, (value + 1) % p, proof)
        if ok is not True or bad is not False or (hiding is None) != (proof.rand_v is None):
            raise AssertionError(f"KZG10 on BLS12-381 (hiding {hiding}): the opening does "
                                 "not check, or a wrong value does")
    torch.cuda.synchronize()
    wide = dict(cuda_build.WIDE)
    log(f"kzg10 bls12_381 degree 2^{log2}: setup, commit, open and check (hiding None and 2) "
        f"in {time.perf_counter() - t0:.3f} s; 12-word launches {json.dumps(wide)} [{card}]")
    missing = [k for k in MARLIN_KERNELS if wide[k] <= 0]
    if missing:
        raise AssertionError(f"12-word kernels not launched by the KZG10 round trip: {missing}")
    return wide


# ---------------------------------------------------------------- PLONK, aSVC
PLONK_LOG2 = 15  # n = 2^15 gates (2^15 - 1 squarings and the public input's), 4n = 2^17
# (2^16 until the sharded prove's phase came, cut as Marlin)
ASVC_LOG2 = 19  # 2^19 positions over BLS12-381 (2^20 until the sharded prove's phase
# came: cut to keep the smoke within its time limit)


def plonk_square_chain(n_gates: int, p: int, x0: int):
    """The smoke's PLONK circuit through the composer: x_(i+1) = x_i * x_i
    (`create_mul_gate(x_i, x_i, x_(i+1))`) for n_gates - 1 gates, then the
    last x made the one public input (`constrain_to_constant(x, 0, pi=x)`).
    Returns the composer and its public inputs (zero but at that gate)."""
    from ckb_zkp_tpu_torch.schemes.plonk import Composer

    cs = Composer(p)
    x = x0 % p
    v = cs.alloc_and_assign(x)
    for _ in range(n_gates - 1):
        x = x * x % p
        nxt = cs.alloc_and_assign(x)
        cs.create_mul_gate(v, v, nxt)
        v = nxt
    cs.constrain_to_constant(v, 0, pi=x)
    return cs, cs.public_inputs()


def plonk_reference_proof(device: str) -> dict:
    """`tests/test_plonk.py`'s circuit over BLS12-381 (SRS 64,
    `random.Random(21)`) on `device`: the vk and proof bytes (hex). Fails
    unless the proof verifies and `[1] + publics[1:]` is refused."""
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.schemes.plonk import Composer, Plonk, default_ks
    from ckb_zkp_tpu_torch.schemes.plonk import serialize as pser

    curve = get_curve("bls12_381")
    p = curve.fr.modulus
    cs = Composer(p)
    v1, v2, v3, v4, v6 = (cs.alloc_and_assign(x) for x in (1, 2, 3, 4, 6))
    cs.create_add_gate((v1, 1), (v2, 1), v3)
    cs.create_add_gate((v1, 1), (v3, 1), v4)
    cs.create_mul_gate(v2, v2, v4)
    cs.create_mul_gate(v1, v2, v6, q_m=2, q_c=2)
    cs.constrain_to_constant(v6, 6)
    rng = random.Random(21)
    srs = Plonk.setup(curve, 64, rng, device=device)
    pk, vk = Plonk.keygen(curve, srs, cs, default_ks(p))
    proof = Plonk.prove(curve, pk, cs, rng)
    publics = cs.public_inputs()
    if not Plonk.verify(curve, vk, publics, proof) or Plonk.verify(
            curve, vk, [1] + publics[1:], proof):
        raise AssertionError(f"the reference PLONK proof on {device} does not verify, or a "
                             "changed public input does")
    return {"vk": pser.vk_to_bytes(curve, vk).hex(),
            "proof": pser.proof_to_bytes(curve, proof).hex()}


def phase_plonk(card: str, log2: int = PLONK_LOG2) -> dict:
    """PLONK over BN254 on the card: `Plonk.setup` of 4n + 1 powers (K6
    twice, K1), `keygen` (the index's transforms, K1; its 11 commitments,
    K2-K5) and `prove` of the 2^log2-gate square chain, each stage timed
    (the `HDomain` transforms apart from the host rounds, `TransformClock`),
    `verify` on the public inputs and on a changed one; the vk and proof
    through the ark-0.2 bytes and back unchanged; the contract verifier's OK
    and ERR_VERIFY on those cells; every kernel of K1-K6 launched by the
    phase; then a warm prove under the profiler. Returns the phase's
    launches, seconds, stages, peak memory and the profile."""
    import torch

    from ckb_zkp_tpu_torch import contracts
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.schemes.plonk import Plonk, default_ks
    from ckb_zkp_tpu_torch.schemes.plonk import serialize as pser
    from ckb_zkp_tpu_torch.serialize.ark_schemes import FR, Vec, ark_encode

    curve = get_curve("bn254")
    p = curve.fr.modulus
    n = 1 << log2
    rng = random.Random(SEED + 17)
    t0 = time.perf_counter()
    cs, publics = plonk_square_chain(n, p, rng.randrange(2, p))
    secs: dict = {"circuit": time.perf_counter() - t0}
    clock = TransformClock()
    torch.cuda.synchronize()
    cuda_build.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srs = Plonk.setup(curve, 4 * n, rng, device=DEVICE)
    torch.cuda.synchronize()
    secs["setup"] = time.perf_counter() - t0
    log(f"plonk setup: {srs.max_degree + 1} powers, {secs['setup']:.3f} s; launches "
        f"{json.dumps(cuda_build.COUNTS)} [{card}]")
    with clock.installed():
        keygen_t: dict = {}
        t0 = time.perf_counter()
        pk, vk = Plonk.keygen(curve, srs, cs, default_ks(p), keygen_t)
        secs["keygen"] = time.perf_counter() - t0
        keygen_dev = clock.take()
        log(f"plonk keygen: {cs.size()} gates, n = {vk.info.n}, {secs['keygen']:.3f} s "
            f"{json.dumps(keygen_t)}; HDomain device transforms {json.dumps(keygen_dev)} "
            f"[{card}]")
        prove_t: dict = {}
        t0 = time.perf_counter()
        proof = Plonk.prove(curve, pk, cs, rng, prove_t)
        secs["prove"] = time.perf_counter() - t0
        prove_dev = clock.take()
    log(f"plonk prove: {secs['prove']:.3f} s {json.dumps(prove_t)}; HDomain device "
        f"transforms {json.dumps(prove_dev)} [{card}]")
    bad = publics[:-1] + [(publics[-1] + 1) % p]
    t0 = time.perf_counter()
    ok = Plonk.verify(curve, vk, publics, proof)
    secs["verify"] = time.perf_counter() - t0
    refused = Plonk.verify(curve, vk, bad, proof) is False
    launches = {k: cuda_build.COUNTS[k] for k in MARLIN_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    log(f"plonk verify: {ok} in {secs['verify']:.3f} s; changed public input refused: "
        f"{refused}")
    if ok is not True or not refused:
        raise AssertionError("the PLONK proof does not verify, or one with a changed public "
                             "input does")
    t0 = time.perf_counter()
    vk_cell, proof_cell = pser.vk_to_bytes(curve, vk), pser.proof_to_bytes(curve, proof)
    vk2, proof2 = pser.vk_from_bytes(curve, vk_cell), pser.proof_from_bytes(curve, proof_cell)
    if (pser.vk_to_bytes(curve, vk2) != vk_cell or pser.proof_to_bytes(curve, proof2)
            != proof_cell or proof2 != proof or vk2.comms != vk.comms or vk2.info != vk.info):
        raise AssertionError("the PLONK vk or proof does not come back unchanged from its bytes")
    secs["bytes"] = time.perf_counter() - t0
    codes = [contracts.universal_plonk_verifier("bn254", vk_cell, proof_cell,
                                                ark_encode(curve, x, Vec(FR)))
             for x in (publics, bad)]
    log(f"plonk bytes: vk {len(vk_cell)} B, proof {len(proof_cell)} B, round trip "
        f"{secs['bytes']:.3f} s; universal_plonk_verifier on the cells: {codes} (OK "
        f"{contracts.OK}, ERR_VERIFY {contracts.ERR_VERIFY})")
    if codes != [contracts.OK, contracts.ERR_VERIFY]:
        raise AssertionError(f"the PLONK contract verifier gave {codes} on the cells")
    log(f"plonk launches (setup to the contract verifier): {json.dumps(cuda_build.COUNTS)}; "
        f"peak device memory {peak} bytes [{card}]")
    missing = [k for k in MARLIN_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the PLONK phase: {missing}")
    warm_t: dict = {}
    prof = profiled(lambda: Plonk.prove(curve, pk, cs, random.Random(SEED + 18), warm_t))
    log(f"plonk prove, warm, profiled: {json.dumps(prof)}; stages {json.dumps(warm_t)} "
        f"[{card}]")
    return {"launches": launches, "seconds": secs, "keygen_stages": keygen_t,
            "prove_stages": prove_t, "keygen_device": keygen_dev, "prove_device": prove_dev,
            "peak_bytes": peak, "warm": prof, "warm_stages": warm_t}


def phase_plonk_reference(card: str, want: dict) -> None:
    """The reference PLONK circuit's vk and proof bytes on the card against
    the port's CPU ones from the plain versions (`start_mini_cpu`'s child)."""
    t0 = time.perf_counter()
    got = plonk_reference_proof(DEVICE)
    if got != want:
        raise AssertionError("the reference PLONK proof on the card differs from the CPU one")
    log(f"plonk reference circuit (bls12_381): the vk and proof bytes on the card "
        f"({time.perf_counter() - t0:.3f} s) equal the port's CPU ones; both verify, "
        f"[1] + publics[1:] refused [{card}]")


def phase_asvc(card: str, log2: int = ASVC_LOG2) -> dict:
    """aSVC over BLS12-381 at 2^log2 positions on the card: `key_gen` (its
    stages timed: the tau powers, the host window tables, the fixed-base
    MSMs of the G1 and G2 powers and of the update keys, the host decode
    of the G2 powers and of the update keys) under the profiler; `commit`
    of 2^log2 random values; `prove_pos`/`verify_pos` at one position and
    at 16, a wrong value refused; `verify_upk` on the right and a wrong
    position; `update_commit` + `update_proof` at the same position and at
    another; `aggregate_proofs` of two single-position proofs, each and
    the aggregate verified. Fails unless every verdict is as
    `tests/test_asvc.py` expects and the phase launched the 12-word K1-K6,
    the fixed-base K6 five times (G1 powers, G2 powers, a_i, l_i, u_i).
    Returns the launches (12-word: `wide`; K1 at 8 words, Fr: `fr_mont_mul`),
    the seconds, key_gen's stages, peak memory and the profile."""
    import torch

    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.schemes import asvc

    curve = get_curve("bls12_381")
    p = curve.fr.modulus
    n = 1 << log2
    rng = random.Random(SEED + 19)
    torch.cuda.synchronize()
    cuda_build.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    secs: dict = {}
    kg: dict = {}
    out: dict = {}
    prof = profiled(lambda: out.update(params=asvc.key_gen(curve, n, rng, DEVICE, kg)))
    params = out["params"]
    secs["key_gen"] = prof["wall_s"]
    fixed = cuda_build.WIDE["rcb_fixed_base"]
    peak_key_gen = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    log(f"asvc key_gen: n = {params.n}, {secs['key_gen']:.3f} s {json.dumps(kg)}; "
        f"12-word fixed-base launches {fixed}; peak device memory {peak_key_gen} bytes; "
        f"profiled {json.dumps(prof)} [{card}]")
    if fixed != 5 or len(params.verification_key.powers_of_g2) != n + 1:
        raise AssertionError("aSVC's key_gen did not run the five fixed-base MSMs (G1 powers, "
                             "G2 powers, a_i, l_i, u_i) on the card")

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        return r

    t0 = time.perf_counter()
    values = [rng.randrange(p) for _ in range(n)]
    secs["values"] = time.perf_counter() - t0
    c = timed("commit", lambda: asvc.commit(params, values))
    i, j, k = rng.sample(range(n), 3)
    many = sorted(rng.sample(range(n), 16))
    uks = params.proving_key.update_keys
    delta = rng.randrange(p)
    proof_i = timed("prove_pos_1", lambda: asvc.prove_pos(params, values, [i]))
    proof_many = timed("prove_pos_16", lambda: asvc.prove_pos(params, values, many))
    proof_k = timed("prove_pos_1", lambda: asvc.prove_pos(params, values, [k]))
    swapped = [values[x] for x in many]
    swapped[0], swapped[1] = swapped[1], swapped[0]
    verdicts = {
        "pos_1": timed("verify_pos_1", lambda: asvc.verify_pos(params, c, [values[i]], [i],
                                                               proof_i)),
        "pos_1_wrong": not asvc.verify_pos(params, c, [(values[i] + 1) % p], [i], proof_i),
        "pos_16": timed("verify_pos_16", lambda: asvc.verify_pos(
            params, c, [values[x] for x in many], many, proof_many)),
        "pos_16_swapped": not asvc.verify_pos(params, c, swapped, many, proof_many),
        "upk": timed("verify_upk", lambda: asvc.verify_upk(params, i, uks[i])),
        "upk_wrong": not asvc.verify_upk(params, j, uks[i]),
    }
    t0 = time.perf_counter()
    uc_i = asvc.update_commit(params, c, delta, i, uks[i])
    same = asvc.update_proof(params, proof_i, delta, i, i, uks[i], uks[i])
    uc_j = asvc.update_commit(params, c, delta, j, uks[j])
    other = asvc.update_proof(params, proof_i, delta, i, j, uks[i], uks[j])
    agg = asvc.aggregate_proofs(params, [i, k], [proof_i, proof_k])
    secs["update_and_aggregate"] = time.perf_counter() - t0
    verdicts |= {
        "update_same": asvc.verify_pos(params, uc_i, [(values[i] + delta) % p], [i], same),
        "update_other": asvc.verify_pos(params, uc_j, [values[i]], [i], other),
        "pos_k": asvc.verify_pos(params, c, [values[k]], [k], proof_k),
        "aggregate": asvc.verify_pos(params, c, [values[i], values[k]], [i, k], agg),
        "aggregate_wrong": not asvc.verify_pos(params, c, [values[k], values[i]], [i, k], agg),
    }
    torch.cuda.synchronize()
    wide = dict(cuda_build.WIDE)
    fr_k1 = cuda_build.COUNTS["mont_mul"] - wide["mont_mul"]
    peak = torch.cuda.max_memory_allocated()
    log(f"asvc 2^{log2}: seconds {json.dumps(secs)}; verdicts {json.dumps(verdicts)}; "
        f"12-word launches {json.dumps(wide)}, Fr K1 {fr_k1}; peak device memory after "
        f"key_gen {peak} bytes [{card}]")
    wrong = [name for name, v in verdicts.items() if v is not True]
    if wrong:
        raise AssertionError(f"aSVC verdicts not as expected: {wrong}")
    missing = [name for name in MARLIN_KERNELS if wide[name] <= 0] + (
        [] if fr_k1 > 0 else ["mont_mul (8 words, Fr)"])
    if missing:
        raise AssertionError(f"kernels not launched by the aSVC phase: {missing}")
    return {"wide": wide, "fr_mont_mul": fr_k1, "seconds": secs, "key_gen_stages": kg,
            "peak_bytes": max(peak, peak_key_gen), "peak_key_gen_bytes": peak_key_gen,
            "profile": prof}


# ------------------------------------------------------------------ Spartan
# (label, curve, scheme, log2 constraints, contract verifiers). Each run is
# a square chain whose witness count equals its constraint count. (a) the
# NIZK over BN254 at 2^19 (2^20 until the Bulletproofs/Hyrax/Libra phase came:
# cut to keep the smoke within its time limit): its witness commitment is 512
# rows of 1024 scalars on the RCB engine, its sumcheck tables 2^19 and 2^20
# rows; (b)
# the NIZK over curve25519 at 2^19, the least whose commitment rows (1024
# scalars) reach FIXED_BASE_MSM_MIN, on the Ristretto group; (c) the SNARK
# over BN254 at 2^16, the least whose SPARK encoding (15 lists of 2^16
# entries, padded to 2^20) commits in rows of 1024 on the device; its
# setup's 786 432 generators are fixed-base MSMs on the card
# (`generator_multiples`). A run with contract verifiers verifies through
# them (OK, then ERR_VERIFY on a changed public input): they decode the
# cells, hash the R1CS and run the verifier.
SPARTAN_RUNS = (
    ("a", "bn254", "nizk", 19, True),
    ("b", "curve25519", "nizk", 19, False),
    ("c", "bn254", "snark", 16, True),
)
SPARTAN_KERNELS = ("mont_mul", "scan_prefix_madd", "scan_prefix_add", "scan_total_add",
                   "rcb_add", "rcb_fixed_base")  # K1-K5 on the RCB engine's path, K6 the generators


def spartan_curve(name: str):
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.host.ristretto import Curve25519

    return Curve25519() if name == "curve25519" else get_curve(name)


ROUND_METHODS = ("cubic_round", "quad_round", "cubic3_round_many", "libra_p1_round",
                 "libra_p2_round", "hyrax_p1_round", "hyrax_p23_round")  # DeviceSumcheck's


def spartan_sumchecks() -> tuple:
    """Spartan's sumchecks: NIZK phases one and two, SNARK's cubic."""
    from ckb_zkp_tpu_torch.schemes.spartan import nizk, snark

    return ((nizk, "sum_check_phase_one"), (nizk, "sum_check_phase_two"),
            (snark, "sum_check_cubic_prover"))


def gkr_sumchecks() -> tuple:
    """Hyrax's and Libra's sumchecks: a Hyrax layer's zk sumcheck, and each
    phase of a Libra layer (plain: the device or the host prover; zk: the
    prover over either round engine)."""
    from ckb_zkp_tpu_torch.schemes.hyrax.zk_sumcheck import ZkSumcheckProof
    from ckb_zkp_tpu_torch.schemes.libra import linear_gkr
    from ckb_zkp_tpu_torch.schemes.libra.zk_linear_gkr import ZKSumCheckProof

    return ((ZkSumcheckProof, "prover"), (linear_gkr, "_phase_one_device"),
            (linear_gkr, "_phase_two_device"), (linear_gkr, "phase_one_prover"),
            (linear_gkr, "phase_two_prover"), (ZKSumCheckProof, "phase_one_prover"),
            (ZKSumCheckProof, "phase_two_prover"))


@contextlib.contextmanager
def device_calls_counted(sumchecks: tuple):
    """Counts, while open, where a scheme's MSMs over a generator list and
    its sumchecks ran, as the launches show. A call of
    `msm_over_fixed_base_many` (`msm_over_fixed_base` is one row of it)
    counts one device call, and its rows on the device, when the device
    group's `msm_many` ran them and launched kernels; its other rows count
    as host MSMs. A sumcheck (each (owner, name) of `sumchecks`, e.g.
    `spartan_sumchecks()`) counts on the device when a `DeviceSumcheck`
    round method ran in it and launched kernels (`sumcheck_device_rounds`
    counts those rounds), else on the host. `generators` counts the
    points `generator_multiples` made, `generators_device` those a
    launching `fixed_base_msm` made. Yields the dict of counts."""
    from ckb_zkp_tpu_torch.ops import cuda_build, msm
    from ckb_zkp_tpu_torch.ops.sumcheck import DeviceSumcheck

    n = dict.fromkeys(("msm_device", "msm_device_rows", "msm_host", "sumcheck_device",
                       "sumcheck_device_rounds", "sumcheck_host", "generators",
                       "generators_device"), 0)
    G = msm.DeviceCurveGroup
    sites = [(msm, "msm_over_fixed_base_many"), (msm, "generator_multiples"),
             (G, "msm_many"), (G, "fixed_base_msm"),
             *((DeviceSumcheck, r) for r in ROUND_METHODS), *sumchecks]
    # the callables, and the raw attributes (a classmethod as itself) to restore
    saved = {site: getattr(*site) for site in sites}
    raw = {site: vars(site[0])[site[1]] for site in sites}
    live = {"rows": 0, "rounds": 0}

    def launches() -> int:
        return sum(cuda_build.COUNTS.values())

    def many(curve, base, rows, *a, **kw):
        r0 = live["rows"]
        out = saved[msm, "msm_over_fixed_base_many"](curve, base, rows, *a, **kw)
        dev = live["rows"] - r0
        n["msm_device"] += dev > 0
        n["msm_device_rows"] += dev
        n["msm_host"] += len(rows) - dev
        return out

    def generators(curve, scalars, *a, **kw):
        n["generators"] += len(scalars)
        return saved[msm, "generator_multiples"](curve, scalars, *a, **kw)

    def msm_many(self, jobs):
        k = launches()
        out = saved[G, "msm_many"](self, jobs)
        live["rows"] += len(jobs) if launches() > k else 0
        return out

    def fixed_base_msm(self, table, scalars, *a, **kw):
        k = launches()
        out = saved[G, "fixed_base_msm"](self, table, scalars, *a, **kw)
        n["generators_device"] += scalars.shape[0] if launches() > k else 0
        return out

    def round_method(site):
        def run(self, *a, **kw):
            k = launches()
            out = saved[site](self, *a, **kw)
            live["rounds"] += launches() > k
            return out
        return run

    def sumcheck(site):
        def run(*a, **kw):
            r0 = live["rounds"]
            out = saved[site](*a, **kw)
            dev = live["rounds"] - r0
            n["sumcheck_device"] += dev > 0
            n["sumcheck_device_rounds"] += dev
            n["sumcheck_host"] += dev == 0
            return out
        return run

    wrapped = {(msm, "msm_over_fixed_base_many"): many, (msm, "generator_multiples"): generators,
               (G, "msm_many"): msm_many, (G, "fixed_base_msm"): fixed_base_msm,
               **{(DeviceSumcheck, r): round_method((DeviceSumcheck, r)) for r in ROUND_METHODS},
               **{site: sumcheck(site) for site in sumchecks}}
    for site in sites:
        setattr(*site, wrapped[site])
    try:
        yield n
    finally:
        for site in sites:
            setattr(*site, raw[site])


@contextlib.contextmanager
def k1_by_modulus():
    """K1 launches tallied by the field's name while open (the field's
    `mont_mul` calls, each a launch on a CUDA tensor: `cuda_build.COUNTS`
    before and after)."""
    from ckb_zkp_tpu_torch.ops import cuda_build, field

    tally: dict = {}
    real = field.mont_mul

    def counted(df, a, b):
        k = cuda_build.COUNTS["mont_mul"]
        out = real(df, a, b)
        tally[df.spec.name] = tally.get(df.spec.name, 0) + cuda_build.COUNTS["mont_mul"] - k
        return out

    field.mont_mul = counted
    try:
        yield tally
    finally:
        field.mont_mul = real


def spartan_mini_proofs(device: str) -> dict:
    """The Mini circuit's NIZK (`random.Random(55)`) and SNARK
    (`random.Random(99)`) proofs on BN254 and curve25519, as
    `tests/test_spartan.py` seeds them, on `device`, with
    FIXED_BASE_MSM_MIN and DEVICE_SUMCHECK_MIN patched to 2 so that every
    commitment of two or more scalars and every sumcheck runs the device
    path; each verified and [11] refused. Returns the proofs' ark bytes
    (hex)."""
    from ckb_zkp_tpu_torch.circuits import Mini
    from ckb_zkp_tpu_torch.ops import msm, sumcheck
    from ckb_zkp_tpu_torch.schemes.spartan import nizk, snark
    from ckb_zkp_tpu_torch.serialize.ark_schemes import ark_encode

    saved = (msm.FIXED_BASE_MSM_MIN, sumcheck.DEVICE_SUMCHECK_MIN)
    msm.FIXED_BASE_MSM_MIN = sumcheck.DEVICE_SUMCHECK_MIN = 2
    out = {}
    try:
        for name in ("bn254", "curve25519"):
            curve = spartan_curve(name)
            rng = random.Random(55)
            r1cs = nizk.generate_r1cs(curve, Mini.power_off())
            params = nizk.generate_setup_parameters(curve, rng, r1cs.num_aux, r1cs.num_inputs)
            h = (r1cs.r1cs_to_hash(), nizk.params_to_hash(curve, params))
            proof = nizk.create_nizk_proof(curve, params, r1cs, Mini.power_on(2, 3, 10), *h, rng,
                                           device)
            verdicts = [nizk.verify_nizk_proof(curve, params, r1cs, [x], proof, *h, device)
                        for x in (10, 11)]
            out[f"nizk_{name}"] = ark_encode(curve, proof).hex()
            rng = random.Random(99)
            st = snark.generate_random_parameters(curve, Mini.power_off(), rng, device)
            h = (st.r1cs.r1cs_to_hash(), snark.snark_params_to_hash(curve, st.params),
                 snark.encode_to_hash(curve, st.encode_commit))
            proof = snark.create_snark_proof(curve, st.params, st.r1cs, Mini.power_on(2, 3, 10),
                                             st.encode, st.encode_commit, *h, rng, device)
            verdicts += [snark.verify_snark_proof(curve, st.params, st.r1cs, [x], proof,
                                                  st.encode_commit, *h, device) for x in (10, 11)]
            out[f"snark_{name}"] = ark_encode(curve, proof).hex()
            if verdicts != [True, False, True, False]:
                raise AssertionError(f"Spartan Mini on {device} ({name}): verdicts {verdicts}")
    finally:
        msm.FIXED_BASE_MSM_MIN, sumcheck.DEVICE_SUMCHECK_MIN = saved
    return out


def start_spartan_mini(device: str):
    """`spartan_mini_proofs` on `device` in a child process (torch on 2
    threads): on "cpu" from the plain versions, started after the build so
    that it runs while the earlier phases use the card; on "cuda" beside
    the Spartan runs. `finish_mini_cpu` reads its proofs."""
    import subprocess

    code = ("import json, sys, torch; torch.set_num_threads(2); sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; print(json.dumps(chip_smoke.spartan_mini_proofs(sys.argv[2])))")
    return subprocess.Popen([sys.executable, "-c", code, REPO, device], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def spartan_run(card: str, label: str, curve_name: str, kind: str, log_c: int,
                contract: bool, profile: bool) -> dict:
    """One Spartan run on the card through the entry points a user calls:
    a square chain of 2^log_c constraints and as many witnesses; the setup
    (NIZK:
    `generate_r1cs` and `generate_setup_parameters`; SNARK:
    `generate_random_parameters`, its stages timed) and the hashes; the
    prove (its stages timed; under the profiler with `profile`); the proof
    (and with `contract` the verifying key) through the ark-0.2 bytes and
    back unchanged; then verification on the public input and refusal of a
    changed one: with `contract` by the contract verifier on those cells
    (OK and ERR_VERIFY), else by `verify_*_proof`. Counts the device and
    host calls of `msm_over_fixed_base` and of the sumchecks, the K1-K5
    launches and K1 by field. Returns JSON-able results."""
    import torch

    from ckb_zkp_tpu_torch import contracts
    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.schemes.spartan import nizk, snark
    from ckb_zkp_tpu_torch.serialize.ark_schemes import S, Tup, ark_decode, ark_encode

    curve = spartan_curve(curve_name)
    p = curve.fr.modulus
    n_c = 1 << log_c
    rng = random.Random(SEED + 23)
    x0 = rng.randrange(2, p)
    circuit = SquareChain(n_c, p, x0)
    public = circuit.chain()[-1]
    secs: dict = {}
    setup_t: dict = {}
    prove_t: dict = {}
    out: dict = {}
    prof = None
    torch.cuda.synchronize()
    cuda_build.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with device_calls_counted(spartan_sumchecks()) as counts, k1_by_modulus() as k1:
        t0 = time.perf_counter()
        if kind == "nizk":
            r1cs = nizk.generate_r1cs(curve, SquareChain(n_c, p))
            setup_t["r1cs"] = time.perf_counter() - t0
            params = nizk.generate_setup_parameters(curve, rng, r1cs.num_aux, r1cs.num_inputs,
                                                    DEVICE)
            setup_t["params"] = time.perf_counter() - t0 - setup_t["r1cs"]
            vk, cls = (params, r1cs), nizk.NIZKProof
            vk_spec = Tup(S(nizk.NizkParameters), S(nizk.R1CSInstance))
        else:
            st = snark.generate_random_parameters(curve, SquareChain(n_c, p), rng, DEVICE,
                                                  setup_t)
            r1cs, params = st.r1cs, st.params
            vk, cls = (params, r1cs, st.encode_commit), snark.SNARKProof
            vk_spec = Tup(S(snark.SnarkParameters), S(nizk.R1CSInstance), S(snark.EncodeCommit))
        secs["setup"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if kind == "nizk":
            hashes = (r1cs.r1cs_to_hash(), nizk.params_to_hash(curve, params))
        else:
            hashes = (r1cs.r1cs_to_hash(), snark.snark_params_to_hash(curve, params),
                      snark.encode_to_hash(curve, st.encode_commit))
        secs["hashes"] = time.perf_counter() - t0

        def prove():
            if kind == "nizk":
                return nizk.create_nizk_proof(curve, params, r1cs, circuit, *hashes, rng, DEVICE,
                                              prove_t)
            return snark.create_snark_proof(curve, params, r1cs, circuit, st.encode,
                                            st.encode_commit, *hashes, rng, DEVICE, prove_t)

        if profile:
            prof = profiled(lambda: out.update(proof=prove()))
            secs["prove"] = prof["wall_s"]
        else:
            t0 = time.perf_counter()
            out["proof"] = prove()
            torch.cuda.synchronize()
            secs["prove"] = time.perf_counter() - t0
        proof = out["proof"]
        peak = torch.cuda.max_memory_allocated()
        prove_counts = dict(counts)
        t0 = time.perf_counter()
        proof_cell = ark_encode(curve, proof)
        vk_cell = ark_encode(curve, vk, vk_spec) if contract else b""
        if ark_encode(curve, ark_decode(curve, proof_cell, cls)) != proof_cell or (
                contract and ark_encode(curve, ark_decode(curve, vk_cell, vk_spec), vk_spec)
                != vk_cell):
            raise AssertionError(f"Spartan ({label}): the proof or the vk does not come back "
                                 "from its bytes")
        secs["bytes"] = time.perf_counter() - t0
        verdicts = []
        for x in (public, (public + 1) % p):
            t0 = time.perf_counter()
            if contract:
                entry = getattr(contracts, f"universal_spartan_{kind}_verifier")
                verdicts.append(entry(curve_name, vk_cell, proof_cell,
                                      x.to_bytes(curve.fr.nbytes, "little"), DEVICE))
            elif kind == "nizk":
                verdicts.append(nizk.verify_nizk_proof(curve, params, r1cs, [x], proof, *hashes,
                                                       DEVICE))
            else:
                verdicts.append(snark.verify_snark_proof(curve, params, r1cs, [x], proof,
                                                         st.encode_commit, *hashes, DEVICE))
            secs["verify" if x == public else "verify_changed"] = time.perf_counter() - t0
    launches = {k: cuda_build.COUNTS[k] for k in SPARTAN_KERNELS}
    want = [contracts.OK, contracts.ERR_VERIFY] if contract else [True, False]
    how = "contract verifier" if contract else "verify"
    log(f"spartan ({label}) {kind} {curve_name}, 2^{log_c} constraints and witnesses: "
        f"seconds {json.dumps(secs)}; setup stages {json.dumps(setup_t)}; prove stages "
        f"{json.dumps(prove_t)}; {how} on the public input and a changed one: {verdicts}; "
        f"proof {len(proof_cell)} B, vk {len(vk_cell)} B [{card}]")
    log(f"spartan ({label}) device and host calls (prove {json.dumps(prove_counts)}; setup to "
        f"verify {json.dumps(counts)}); launches {json.dumps(launches)}; K1 by "
        f"field {json.dumps(k1)}; peak device memory after the prove {peak} bytes [{card}]")
    if profile:
        log(f"spartan ({label}) prove, profiled: {json.dumps(prof)} [{card}]")
    if verdicts != want:
        raise AssertionError(f"Spartan ({label}): {how} gave {verdicts}, not {want}")
    return {"seconds": secs, "setup_stages": setup_t, "prove_stages": prove_t,
            "counts": dict(counts), "prove_counts": prove_counts, "launches": launches,
            "k1": k1, "peak_bytes": peak, "profile": prof, "verdicts": verdicts}


def start_spartan_run(card: str, label: str, profile: bool = False):
    """`spartan_run` of SPARTAN_RUNS' `label` in a child process on the
    card (its own CUDA context and launch counts; its prove under the
    profiler with `profile`); `finish_run` relays its lines and reads its
    results."""
    import subprocess

    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "run = next(r for r in chip_smoke.SPARTAN_RUNS if r[0] == sys.argv[3]); "
            "print(json.dumps(chip_smoke.spartan_run(sys.argv[2], *run, "
            "profile=sys.argv[4] == '1')))")
    return subprocess.Popen([sys.executable, "-c", code, REPO, card, label, str(int(profile))],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start_spartan_runs(card: str) -> dict:
    """The runs of SPARTAN_RUNS, each in a child process on the card, (a)'s
    prove under the profiler: started once the BLS12-381 phase has timed
    its kernel rows, so that they run beside the Marlin, PLONK and aSVC
    phases (host-bound work, like theirs); `phase_spartan` reads them."""
    return {label: start_spartan_run(card, label, profile=label == "a")
            for label, *_ in SPARTAN_RUNS}


def finish_run(child, label: str) -> dict:
    """Relays the lines of a run's child process (`start_spartan_run`,
    `start_dl_run`) and reads its results, its last line."""
    out, err = child.communicate(timeout=1200)
    lines = out.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    if child.returncode != 0:
        raise AssertionError(f"run ({label}) failed: {err[-3000:]}")
    return json.loads(lines[-1])


def phase_spartan_kernels(results: dict, n: int = 1 << 20) -> None:
    """K1 at curve25519's two moduli (Fq = 2^255 - 19, Fr = l): the edge
    products at 2^16 (0, 1, p - 1, R mod p, `mul_edge_check`), then the
    kernel against its plain version at n rows, its first rows 0, 1,
    p - 1 and R mod p times p - 1 (and p - 1 + p - 1 through the plain
    add), beside its bound. Rows "mont_mul_25519_fq" and "mont_mul_25519_fr"."""
    import numpy as np
    import torch

    from ckb_zkp_tpu_torch.ops.field import device_field

    rng = np.random.default_rng(SEED + 29)
    curve = spartan_curve("curve25519")
    for row, spec in (("mont_mul_25519_fq", curve.fq), ("mont_mul_25519_fr", curve.fr)):
        df = device_field(spec, DEVICE)
        p = spec.modulus
        record = Recorder(results)
        mul_edge_check(lambda name, *a, **kw: record(row, *a, **kw), rng, df, spec.name)
        a = rand_field(rng, n, (df.L,), df)
        b = rand_field(rng, n, (df.L,), df)
        a[:4] = df.encode([0, 1, p - 1, df.R])
        b[:4] = df.encode([p - 1, p - 1, p - 1, p - 1])
        k = df.mul(a, b)
        pl, plain_ms = timed_once(lambda: df.plain.mul(a, b))
        torch.cuda.synchronize()
        if df.decode(k[:4]) != [0, p - 1, 1, df.R * (p - 1) % p] or \
                df.decode(df.add(a[2:3], a[2:3])) != [p - 2]:
            raise AssertionError(f"mont_mul edge values wrong ({spec.name} n={n})")
        record(row, max_abs_err(k, pl), cuda_ms(lambda: df.mul(a, b), 10), plain_ms,
               f"{spec.name} n={n}; the Spartan runs' field",
               (3 * n * FQ_BYTES, n * IMAD_PER_FQ_MUL))
        del a, b, k, pl
    torch.cuda.empty_cache()


def phase_spartan(card: str, cpu_child, run_children: dict) -> dict:
    """Spartan on the card: the runs of SPARTAN_RUNS (`spartan_run`), in the
    child processes of `start_spartan_runs`, read here, beside the Mini
    proofs (thresholds at 2) in another child on the card, whose bytes must
    equal the CPU child's. Every run must make device calls of
    `msm_over_fixed_base` and of the sumchecks (as `device_calls_counted`
    observes them); (a) must launch K1, K2, K5 and K6 (its generators) and
    (b) K1 at 2^255 - 19 and at l. Returns the runs, the K1-K5 launches of
    the three runs together and (b)'s K1 launches by field."""
    t0 = time.perf_counter()
    mini = start_spartan_mini(DEVICE)
    try:
        runs = {label: finish_run(child, label) for label, child in run_children.items()}
        runs_s = time.perf_counter() - t0
        got = finish_mini_cpu(mini)
        wall = time.perf_counter() - t0
    finally:
        for child in [mini, *run_children.values()]:
            if child.poll() is None:
                child.kill()
                child.wait()
    for label in runs:
        c = runs[label]["counts"]
        if c["msm_device"] <= 0 or c["sumcheck_device"] <= 0:
            raise AssertionError(f"Spartan ({label}) made no device call of "
                                 f"msm_over_fixed_base or of a sumcheck: {c}")
    need = {"a": [k for k in ("mont_mul", "scan_prefix_madd", "rcb_add", "rcb_fixed_base")
                  if runs["a"]["launches"][k] <= 0],
            "b": [k for k in ("curve25519_fq", "curve25519_fr") if runs["b"]["k1"].get(k, 0) <= 0]}
    if need["a"] or need["b"]:
        raise AssertionError(f"Spartan kernels not launched: {need}")
    t1 = time.perf_counter()
    want = finish_mini_cpu(cpu_child)
    cpu_wait = time.perf_counter() - t1
    if got != want:
        raise AssertionError("the Spartan Mini proofs on the card differ from the CPU ones: "
                             f"{[k for k in got if got[k] != want.get(k)]}")
    log(f"spartan mini (thresholds at 2): NIZK and SNARK on bn254 and curve25519, the proof "
        f"bytes of the card's child equal the port's CPU ones; all verify, [11] refused; "
        f"(a), (b), (c) read {runs_s:.3f} s after their slot began, the card's Mini proofs "
        f"{wall:.3f} s, the CPU child's {cpu_wait:.3f} s later [{card}]")
    total = {k: sum(r["launches"][k] for r in runs.values()) for k in SPARTAN_KERNELS}
    return {"runs": runs, "launches": total, "k1_25519": runs["b"]["k1"],
            "runs_s": runs_s, "wall_s": wall}


# ---- Bulletproofs, Hyrax and Libra on the discrete-log layer (phase_dl) ----
# The layers of tests/test_hyrax.py:20-25 and tests/test_libra.py (16 inputs:
# 8 witnesses, then 8 inputs; 8, 4 and 4 gates).
GKR_LAYERS = (
    ((1, 0, 1), (0, 2, 3), (0, 4, 5), (1, 6, 7), (1, 15, 8), (1, 9, 10), (0, 11, 12),
     (0, 13, 14)),
    ((1, 0, 1), (0, 2, 3), (0, 4, 5), (1, 6, 7)),
    ((0, 0, 1), (0, 1, 2), (1, 2, 3), (1, 1, 3)),
)
# (label, scheme, curve, log2 of the size), each the least size where every
# device call of its scheme launches, every wire used: (d), (e) the square
# chain of 2^11 constraints (N = 2048: the commitments and IPP_P device MSMs
# of 2048 scalars, the IPA's first round four of 1024); (f) 2^16 instances of
# the test circuit (the witness commitment 512 rows of 1024, the zk sumcheck
# tables n * ng >= DEVICE_SUMCHECK_MIN * 4); (g) 2^16 copies of it side by
# side as one layered circuit (layers of 2^20 inputs, 2^19, 2^18 and 2^18
# gates: every layer's tables 2^bits >= DEVICE_SUMCHECK_MIN; the zk witness
# commitment 512 rows of 1024); its plain half ("g_plain") runs as a run of
# its own.
DL_RUNS = (
    ("d", "bulletproofs", "bn254", 11),
    ("e", "bulletproofs", "curve25519", 11),
    ("f", "hyrax", "bls12_381", 16),
    ("g", "libra_zk", "bls12_381", 16),
    ("g_plain", "libra_plain", "bls12_381", 16),
)
DL_KERNELS = ("mont_mul", "scan_prefix_madd", "scan_prefix_add", "scan_total_add", "rcb_add",
              "rcb_fixed_base")


def libra_copies_circuit(copies: int):
    """`copies` copies of GKR_LAYERS side by side as one Libra circuit of
    8 * copies inputs and witnesses: copy j's gates read copy j's own
    witnesses (node 8j + i, i < 8) and inputs (node 8 copies + 8j + i - 8)
    in layer 0's layout (`libra/circuit.py`: witnesses, then inputs), and
    its own gates of the layer below."""
    from ckb_zkp_tpu_torch.schemes import libra

    ni = 8 * copies

    def node0(j, i):
        return 8 * j + i if i < 8 else ni + 8 * j + i - 8

    layers = [[(op, node0(j, a), node0(j, b)) for j in range(copies)
               for op, a, b in GKR_LAYERS[0]]]
    for width, raw in ((8, GKR_LAYERS[1]), (4, GKR_LAYERS[2])):
        layers.append([(op, width * j + a, width * j + b) for j in range(copies)
                       for op, a, b in raw])
    return libra.Circuit(ni, ni, layers)


def _changed(outputs):
    """The outputs with their first element plus one."""
    if isinstance(outputs[0], list):
        return [_changed(outputs[0])] + [list(o) for o in outputs[1:]]
    return [outputs[0] + 1] + list(outputs[1:])


def _round_trip(curve, label, values: dict) -> dict:
    """Each value's ark bytes, which must decode and encode back unchanged:
    {name: (value, spec)} -> {name: bytes}."""
    from ckb_zkp_tpu_torch.serialize.ark_schemes import ark_decode, ark_encode

    cells = {}
    for name, (value, spec) in values.items():
        cells[name] = ark_encode(curve, value, spec)
        if ark_encode(curve, ark_decode(curve, cells[name], spec, DEVICE), spec) != cells[name]:
            raise AssertionError(f"{label}: the {name} does not come back from its bytes")
    return cells


def bulletproofs_run(card: str, label: str, curve_name: str, log_c: int,
                     profile: bool = False) -> dict:
    """Bulletproofs on the card through `create_random_proof` (the 2N + 3
    generators on K6 or the host, the dense R1CS, the prove; its stages
    timed): the square chain of 2^log_c constraints and as many witnesses;
    the (Generators, R1csCircuit, Proof) cell through its ark bytes and
    back; verification on the public input and refusal of a changed one,
    on BN254 by the contract verifier on that cell (OK, ERR_VERIFY), on
    curve25519 by `verify_proof`."""
    from ckb_zkp_tpu_torch import contracts
    from ckb_zkp_tpu_torch.schemes import bulletproofs as bp
    from ckb_zkp_tpu_torch.serialize.ark_schemes import S, Tup

    curve = spartan_curve(curve_name)
    p = curve.fr.modulus
    rng = random.Random(SEED + 31)
    circuit = SquareChain(1 << log_c, p, rng.randrange(2, p))
    public = circuit.chain()[-1]
    spec = Tup(S(bp.Generators), S(bp.R1csCircuit), S(bp.Proof))

    def prove(t):  # the generators are drawn and made inside, as in the reference
        return bp.create_random_proof(curve, circuit, rng, DEVICE, t)

    def finish(out, secs):
        gens, r1cs, proof = out["proof"]
        t0 = time.perf_counter()
        cell = _round_trip(curve, label, {"cell": ((gens, r1cs, proof), spec)})["cell"]
        secs["bytes"] = time.perf_counter() - t0
        verdicts = []
        for x in (public, (public + 1) % p):
            t0 = time.perf_counter()
            if curve_name == "curve25519":  # the JAX contracts take pairing curves only
                verdicts.append(bp.verify_proof(curve, gens, proof, r1cs, [x]))
            else:
                verdicts.append(contracts.mini_bulletproofs_verifier(
                    curve_name, b"", cell, x.to_bytes(curve.fr.nbytes, "little"), DEVICE))
            secs["verify" if x == public else "verify_changed"] = time.perf_counter() - t0
        want = ([True, False] if curve_name == "curve25519"
                else [contracts.OK, contracts.ERR_VERIFY])
        return verdicts, want, {"cell_bytes": len(cell), "N": gens.N}

    return dl_run(card, label, "bulletproofs", curve, 1 << log_c, None, prove, finish, profile)


def hyrax_run(card: str, label: str, log_n: int, profile: bool = False) -> dict:
    """Hyrax on the card: 2^log_n instances of the test circuit with random
    inputs and witnesses; `Parameters.new` (`gen_n` on K6), the hashes, the
    prove (its stages timed); the parameters, proof and (inputs, outputs)
    through their ark bytes and back; the contract verifier on those cells
    with `circuit=`: OK, and ERR_VERIFY on a changed output."""
    from ckb_zkp_tpu_torch import contracts
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.schemes import hyrax
    from ckb_zkp_tpu_torch.serialize.ark_schemes import FR, S, Tup, Vec

    curve = get_curve("bls12_381")
    p = curve.fr.modulus
    n = 1 << log_n
    rng = random.Random(SEED + 37)
    witnesses = [[rng.randrange(p) for _ in range(8)] for _ in range(n)]
    inputs = [[rng.randrange(p) for _ in range(8)] for _ in range(n)]
    circuit = hyrax.Circuit(8, 8, [list(g) for g in GKR_LAYERS])
    setup: dict = {}

    def make(t):
        t0 = time.perf_counter()
        setup["params"] = params = hyrax.Parameters.new(curve, rng, log_n + 3, DEVICE)
        t["params"] = time.perf_counter() - t0
        setup["hashes"] = (circuit.circuit_to_hash(curve), params.param_to_hash())
        t["hashes"] = time.perf_counter() - t0 - t["params"]

    def prove(t):
        return hyrax.HyraxProof.prover(setup["params"], witnesses, inputs, circuit,
                                       *setup["hashes"], n, rng, DEVICE, t)

    def finish(out, secs):
        proof, outputs = out["proof"]
        pub = Tup(Vec(Vec(FR)), Vec(Vec(FR)))
        t0 = time.perf_counter()
        cells = _round_trip(curve, label, {
            "params": (setup["params"], S(hyrax.Parameters)),
            "proof": (proof, S(hyrax.HyraxProof)),
            "publics": ((inputs, outputs), pub), "changed": ((inputs, _changed(outputs)), pub)})
        secs["bytes"] = time.perf_counter() - t0
        verdicts = []
        for name in ("publics", "changed"):
            t0 = time.perf_counter()
            verdicts.append(contracts.mini_hyrax_zk_linear_gkr_verifier(
                "bls12_381", cells["params"], cells["proof"], cells[name], circuit=circuit,
                device=DEVICE))
            secs["verify" if name == "publics" else "verify_changed"] = time.perf_counter() - t0
        return verdicts, [contracts.OK, contracts.ERR_VERIFY], {
            "proof_bytes": len(cells["proof"]), "params_bytes": len(cells["params"])}

    return dl_run(card, label, "hyrax", curve, n, make, prove, finish, profile)


def libra_run(card: str, label: str, kind: str, log_copies: int,
              profile: bool = False) -> dict:
    """Libra on the card, `kind` "zk" or "plain", on
    `libra_copies_circuit(2^log_copies)` with random inputs and witnesses
    (the same for both kinds): the circuit and its hash (zk: and
    `Parameters.new`, `gen_n` on K6, with its hash), the prove (its stages
    timed); zk: the parameters, proof and
    (inputs, outputs) through their ark bytes and back, and the contract
    verifier on those cells with `circuit=`: OK, and ERR_VERIFY on a
    changed output; plain: `verify` and the refusal of a changed output."""
    from ckb_zkp_tpu_torch import contracts
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.schemes import libra
    from ckb_zkp_tpu_torch.serialize.ark_schemes import FR, S, Tup, Vec

    curve = get_curve("bls12_381")
    p = curve.fr.modulus
    copies = 1 << log_copies
    rng = random.Random(SEED + 41)
    witnesses = [rng.randrange(p) for _ in range(8 * copies)]
    inputs = [rng.randrange(p) for _ in range(8 * copies)]
    setup: dict = {}

    def make(t):
        t0 = time.perf_counter()
        setup["circuit"] = circuit = libra_copies_circuit(copies)
        t["circuit"] = time.perf_counter() - t0
        if kind == "zk":
            setup["params"] = params = libra.Parameters.new(curve, rng, 3 + log_copies, DEVICE)
            t["params"] = time.perf_counter() - t0 - t["circuit"]
        t1 = time.perf_counter()
        setup["hashes"] = (circuit.circuit_to_hash(curve),) + (
            (params.param_to_hash(),) if kind == "zk" else ())
        t["hashes"] = time.perf_counter() - t1

    def prove(t):
        if kind == "plain":
            return libra.LinearGKRProof.prover(curve, setup["circuit"], inputs, witnesses,
                                               *setup["hashes"], DEVICE)
        return libra.ZKLinearGKRProof.prover(setup["params"], setup["circuit"], inputs,
                                             witnesses, *setup["hashes"], rng, DEVICE, t)

    def finish_plain(out, secs):
        proof, output = out["proof"]
        circuit, chash = setup["circuit"], setup["hashes"][0]
        verdicts = []
        for o in (output, _changed(output)):
            t0 = time.perf_counter()
            verdicts.append(proof.verify(curve, circuit, o, witnesses + inputs, chash, DEVICE))
            secs["verify" if o is output else "verify_changed"] = time.perf_counter() - t0
        return verdicts, [True, False], {"gates": [layer.gates_count
                                                   for layer in circuit.layers]}

    def finish_zk(out, secs):
        proof, output = out["proof"]
        pub = Tup(Vec(FR), Vec(FR))
        t0 = time.perf_counter()
        cells = _round_trip(curve, label, {
            "params": (setup["params"], S(libra.Parameters)),
            "proof": (proof, S(libra.ZKLinearGKRProof)),
            "publics": ((inputs, output), pub), "changed": ((inputs, _changed(output)), pub)})
        secs["bytes"] = time.perf_counter() - t0
        verdicts = []
        for name in ("publics", "changed"):
            t0 = time.perf_counter()
            verdicts.append(contracts.mini_libra_zk_linear_gkr_verifier(
                "bls12_381", cells["params"], cells["proof"], cells[name],
                circuit=setup["circuit"], device=DEVICE))
            secs["verify" if name == "publics" else "verify_changed"] = time.perf_counter() - t0
        return verdicts, [contracts.OK, contracts.ERR_VERIFY], {
            "proof_bytes": len(cells["proof"]), "params_bytes": len(cells["params"])}

    return dl_run(card, label, f"libra {kind}", curve, copies, make, prove,
                  finish_zk if kind == "zk" else finish_plain, profile)


def dl_run(card, label, scheme, curve, size, make, prove, finish, profile) -> dict:
    """One run of phase_dl (`bulletproofs_run`, `hyrax_run`, `libra_run`):
    `make(setup_timings)` (the setup and the hashes, where the scheme has
    them apart from its prover), `prove(timings)` (under the profiler with
    `profile`), then `finish(out, secs)` -> (verdicts,
    the verdicts wanted, facts),
    counting the device and host calls of the MSMs over a generator list
    and of the sumchecks (`device_calls_counted`), the K1-K6 launches (the
    12-word ones apart, `cuda_build.WIDE`) and K1 by field, with the peak
    device memory after the prove."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_build

    secs: dict = {}
    setup_t: dict = {}
    prove_t: dict = {}
    out: dict = {}
    prof = None
    torch.cuda.synchronize()
    cuda_build.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with device_calls_counted(gkr_sumchecks()) as counts, k1_by_modulus() as k1:
        if make is not None:
            t0 = time.perf_counter()
            make(setup_t)
            torch.cuda.synchronize()
            secs["setup"] = time.perf_counter() - t0
        if profile:
            prof = profiled(lambda: out.update(proof=prove(prove_t)))
            secs["prove"] = prof["wall_s"]
        else:
            t0 = time.perf_counter()
            out["proof"] = prove(prove_t)
            torch.cuda.synchronize()
            secs["prove"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        prove_counts = dict(counts)
        verdicts, want, facts = finish(out, secs)
    launches = {k: cuda_build.COUNTS[k] - cuda_build.WIDE[k] for k in DL_KERNELS}
    wide = {k: cuda_build.WIDE[k] for k in DL_KERNELS}
    log(f"{scheme} ({label}) {curve.name}, size {size}: seconds {json.dumps(secs)}; setup "
        f"stages {json.dumps(setup_t)}; prove stages {json.dumps(prove_t)}; verdicts "
        f"{verdicts}; {json.dumps(facts)} [{card}]")
    log(f"{scheme} ({label}) device and host calls (prove {json.dumps(prove_counts)}; prove "
        f"to verify {json.dumps(counts)}); launches {json.dumps(launches)}, 12-word "
        f"{json.dumps(wide)}; K1 by field {json.dumps(k1)}; peak device memory after the "
        f"prove {peak} bytes [{card}]")
    if profile:
        log(f"{scheme} ({label}) prove, profiled: {json.dumps(prof)} [{card}]")
    if verdicts != want:
        raise AssertionError(f"{scheme} ({label}): verdicts {verdicts}, not {want}")
    return {"seconds": secs, "setup_stages": setup_t, "prove_stages": prove_t,
            "counts": dict(counts), "prove_counts": prove_counts, "launches": launches,
            "wide": wide, "k1": k1,
            "peak_bytes": peak, "profile": prof, "verdicts": verdicts, "facts": facts}


def start_dl_run(card: str, label: str):
    """The run of DL_RUNS' `label` in a child process on the card (its own
    CUDA context and launch counts); `finish_run` relays its lines and
    reads its results."""
    import subprocess

    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "print(json.dumps(chip_smoke.dl_run_of(sys.argv[2], sys.argv[3])))")
    return subprocess.Popen([sys.executable, "-c", code, REPO, card, label], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def dl_run_of(card: str, label: str, profile: bool = False) -> dict:
    _, scheme, curve_name, log2 = next(r for r in DL_RUNS if r[0] == label)
    if scheme == "bulletproofs":
        return bulletproofs_run(card, label, curve_name, log2, profile)
    if scheme == "hyrax":
        return hyrax_run(card, label, log2, profile)
    return libra_run(card, label, scheme.split("_")[1], log2, profile)


DL_SCHEMES = ("bulletproofs", "hyrax", "libra")


def dl_mini_proofs(device: str, schemes=DL_SCHEMES) -> dict:
    """The reference tests' proofs on `device`, with FIXED_BASE_MSM_MIN and
    DEVICE_SUMCHECK_MIN patched to 2 so that every commitment of two or
    more scalars, the generator lists and every sumcheck run the device
    path: Bulletproofs' Mini on BN254 and curve25519 (`random.Random(77)`,
    tests/test_bulletproofs.py), Hyrax's 4 instances (`random.Random(42)`,
    tests/test_hyrax.py), Libra's reference circuit plain and zk
    (`random.Random(88)`, tests/test_libra.py). On a card each is verified
    and a changed input or output refused. Returns the proofs' ark bytes
    (hex; the plain Libra proof's fields)."""
    from ckb_zkp_tpu_torch.circuits import Mini
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import msm, sumcheck
    from ckb_zkp_tpu_torch.schemes import bulletproofs as bp
    from ckb_zkp_tpu_torch.schemes import hyrax, libra
    from ckb_zkp_tpu_torch.serialize.ark_schemes import ark_encode

    check = device != "cpu"
    layers = [list(g) for g in GKR_LAYERS]
    saved = (msm.FIXED_BASE_MSM_MIN, sumcheck.DEVICE_SUMCHECK_MIN)
    msm.FIXED_BASE_MSM_MIN = sumcheck.DEVICE_SUMCHECK_MIN = 2
    out, verdicts = {}, []
    try:
        if "bulletproofs" in schemes:
            for name in ("bn254", "curve25519"):
                curve = spartan_curve(name)
                gens, r1cs, proof = bp.create_random_proof(curve, Mini.power_on(2, 3, 10),
                                                           random.Random(77), device)
                out[f"bulletproofs_{name}"] = ark_encode(curve, gens).hex() + ark_encode(
                    curve, proof).hex()
                if check:
                    verdicts += [bp.verify_proof(curve, gens, proof, r1cs, [x]) for x in (10, 11)]
        curve = get_curve("bls12_381")
        p = curve.fr.modulus
        if "hyrax" in schemes:
            rng = random.Random(42)
            W = [[rng.randrange(p) for _ in range(8)] for _ in range(4)]
            inputs = [[rng.randrange(p) for _ in range(8)] for _ in range(4)]
            params = hyrax.Parameters.new(curve, rng, 8, device)
            circuit = hyrax.Circuit(8, 8, layers)
            h = (circuit.circuit_to_hash(curve), params.param_to_hash())
            proof, outputs = hyrax.HyraxProof.prover(params, W, inputs, circuit, *h, 4, rng,
                                                     device)
            out["hyrax"] = ark_encode(curve, params).hex() + ark_encode(curve, proof).hex()
            if check:
                verdicts += [proof.verify(params, o, inputs, circuit, *h, device)
                             for o in (outputs, _changed(outputs))]
        if "libra" in schemes:
            inputs, witnesses = list(range(1, 9)), list(range(9, 17))
            circuit = libra.Circuit(8, 8, layers)
            chash = circuit.circuit_to_hash(curve)
            plain, output = libra.LinearGKRProof.prover(curve, circuit, inputs, witnesses, chash,
                                                        device)
            out["libra_plain"] = [[layer.proof_phase_one.polys, layer.proof_phase_one
                                   .poly_value_at_r, layer.proof_phase_two.polys,
                                   layer.proof_phase_two.poly_value_at_r]
                                  for layer in plain.proofs]
            rng = random.Random(88)
            params = libra.Parameters.new(curve, rng, 8, device)
            h = (chash, params.param_to_hash())
            proof, output = libra.ZKLinearGKRProof.prover(params, circuit, inputs, witnesses,
                                                          *h, rng, device)
            out["libra_zk"] = ark_encode(curve, params).hex() + ark_encode(curve, proof).hex()
            if check:
                verdicts += [plain.verify(curve, circuit, o, witnesses + inputs, chash, device)
                             for o in (output, _changed(output))]
                verdicts += [proof.verify(params, circuit, o, inputs, *h, device)
                             for o in (output, _changed(output))]
        if verdicts != [True, False] * (len(verdicts) // 2):
            raise AssertionError(f"DL Mini proofs on {device}: verdicts {verdicts}")
    finally:
        msm.FIXED_BASE_MSM_MIN, sumcheck.DEVICE_SUMCHECK_MIN = saved
    return out


def start_dl_mini_cpu():
    """`dl_mini_proofs` on the CPU (the plain versions) in a child process
    (torch on 2 threads), started after the timed kernel rows.
    `finish_mini_cpu` reads its proofs."""
    import subprocess

    code = ("import json, sys, torch; torch.set_num_threads(2); sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; print(json.dumps(chip_smoke.dl_mini_proofs('cpu')))")
    return subprocess.Popen([sys.executable, "-c", code, REPO], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start_dl_runs(card: str) -> dict:
    """DL_RUNS' (d), (e), (f) and (g)'s plain half, each in a child process
    on the card, started beside the Spartan phase; `phase_dl` reads them."""
    return {label: start_dl_run(card, label) for label in ("d", "e", "f", "g_plain")}


def phase_dl(card: str, cpu_child, children: dict) -> dict:
    """Bulletproofs, Hyrax and Libra on the card: the runs of DL_RUNS. (g)
    runs in this process, its zk prove under the profiler, beside (d),
    (e), (f) and (g)'s plain half in the child processes of
    `start_dl_runs`; then this process makes the card's Mini proofs
    (thresholds at 2) and reads the children. The Mini bytes must equal the
    CPU child's. Every run must make device MSMs, (f) and (g) device
    sumcheck rounds; (d) must launch K1, K2, K5 and K6, (e) K1 at
    2^255 - 19, (f) and (g) the 12-word K2, K5 and K6 and Fr's K1. Returns
    the runs, the 8-word and 12-word K1-K6 launches of the four together
    and (e)'s K1 launches by field."""
    import torch

    t0 = time.perf_counter()
    try:
        runs = {"g": dl_run_of(card, "g", profile=True)}
        torch.cuda.empty_cache()
        g_s = time.perf_counter() - t0
        got = dl_mini_proofs(DEVICE)
        mini_s = time.perf_counter() - t0 - g_s
        for label, child in children.items():
            runs[label] = finish_run(child, label)
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()
    wall = time.perf_counter() - t0
    for label, run in runs.items():
        c = run["counts"]
        if (c["msm_device"] <= 0 and label != "g_plain") or (
                label in ("f", "g", "g_plain") and c["sumcheck_device"] <= 0):
            raise AssertionError(f"DL run ({label}) made no device MSM, or no device "
                                 f"sumcheck: {c}")
    need = {"d": [k for k in ("mont_mul", "scan_prefix_madd", "rcb_add", "rcb_fixed_base")
                  if runs["d"]["launches"][k] <= 0],
            "e": [k for k in ("curve25519_fq",) if runs["e"]["k1"].get(k, 0) <= 0]}
    for label in "fg":
        need[label] = [f"{k}_nw12" for k in ("scan_prefix_madd", "rcb_add", "rcb_fixed_base")
                       if runs[label]["wide"][k] <= 0]
        need[label] += [k for k in ("bls12_381.Fr",) if runs[label]["k1"].get(k, 0) <= 0]
    if any(need.values()):
        raise AssertionError(f"DL kernels not launched: {need}")
    want = finish_mini_cpu(cpu_child)
    if got != want:
        raise AssertionError("the DL Mini proofs on the card differ from the CPU ones: "
                             f"{[k for k in got if got[k] != want.get(k)]}")
    log(f"dl mini (thresholds at 2): Bulletproofs on bn254 and curve25519, Hyrax, Libra "
        f"plain and zk: the card's proofs equal the port's CPU ones; all verify, changed "
        f"inputs and outputs refused; (g) {g_s:.3f} s wall (beside the children), then the "
        f"card's Mini proofs {mini_s:.3f} s, the phase {wall:.3f} s wall [{card}]")
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in DL_KERNELS}
    wide = {k: sum(r["wide"][k] for r in runs.values()) for k in DL_KERNELS}
    return {"runs": runs, "launches": launches, "wide": wide, "k1_25519": runs["e"]["k1"],
            "g_s": g_s, "wall_s": wall}


# ---- the CLI (phase_cli) ----
# The in-process cases: (label, setup arguments or None, prove arguments).
# tests/test_cli.py's round trips, tests/test_jubjub.py's Edwards case
# (a setup over baby jubjub, a Bulletproofs proof over jubjub) and Groth16
# over BLS12-381 Mini, which runs the 12-word kernels.
CLI_MINI = ("2", "3", "10")
CLI_PREIMAGE = "iamsecret"
CLI_CASES = tuple(
    (f"{s}-{c}-{k}", None if s == "bulletproofs" else (s, c, k), (s, c, k, *args))
    for s, c, k, args in (
        ("groth16", "bn254", "mini", CLI_MINI), ("groth16", "bn254", "hash", (CLI_PREIMAGE,)),
        ("groth16", "bls12_381", "mini", CLI_MINI), ("marlin", "bn254", "mini", CLI_MINI),
        ("plonk", "bn254", "mini", CLI_MINI), ("plonk", "bn254", "hash", (CLI_PREIMAGE,)),
        ("bulletproofs", "bn254", "mini", CLI_MINI),
        ("bulletproofs", "curve25519", "mini", CLI_MINI),
        ("spartan_snark", "bn254", "mini", CLI_MINI),
        ("spartan_nizk", "bn254", "mini", CLI_MINI),
        ("spartan_nizk", "curve25519", "mini", CLI_MINI))
) + (("edwards", ("spartan_nizk", "baby_jubjub", "mini"),
      ("bulletproofs", "jubjub", "mini", *CLI_MINI)),)
# the kernels each command must launch on the card ("_nw12": the 12-word
# instance, `cuda_build.WIDE`). At these sizes the RCB MSM's block totals
# stay under `_TOP_MAX`, so no K3; the CBMT circuit's prove launches it.
# The discrete-log schemes' Mini rows stay under FIXED_BASE_MSM_MIN and
# their sumchecks under DEVICE_SUMCHECK_MIN: they run on the host, as the
# JAX package sends them, and launch nothing.
_CLI_MSM = ("mont_mul", "scan_prefix_madd", "scan_total_add", "rcb_add")
CLI_NEEDS = {
    "groth16-bn254-mini": {"setup": ("mont_mul", "rcb_fixed_base"), "prove": _CLI_MSM},
    "groth16-bn254-hash": {"setup": ("mont_mul", "rcb_fixed_base"), "prove": _CLI_MSM},
    "groth16-bls12_381-mini": {
        "setup": ("mont_mul_nw12", "rcb_fixed_base_nw12"),
        "prove": tuple(f"{k}_nw12" for k in _CLI_MSM)},
    "marlin-bn254-mini": {"setup": ("rcb_fixed_base", *_CLI_MSM), "prove": _CLI_MSM},
    "plonk-bn254-mini": {"setup": ("rcb_fixed_base", *_CLI_MSM), "prove": _CLI_MSM},
    "plonk-bn254-hash": {"setup": ("rcb_fixed_base", *_CLI_MSM), "prove": _CLI_MSM},
}
CBMT_LEMMAS = 5  # a 32-leaf tree


def _changed_publics(proof_file: str) -> str:
    """A copy of a proof JSON with its first public input's low bit flipped."""
    with open(proof_file) as f:
        payload = json.load(f)
    raw = bytearray(bytes.fromhex(payload["params"]))
    raw[0] ^= 1
    payload["params"] = bytes(raw).hex()
    out = os.path.join(os.path.dirname(proof_file), "changed-" + os.path.basename(proof_file))
    with open(out, "w") as f:
        json.dump(payload, f)
    return out


def _cli_launches() -> dict:
    """This command's launches: the 8-word kernels by name, the 12-word
    instances as "<name>_nw12"."""
    from ckb_zkp_tpu_torch.ops import cuda_build

    wide = cuda_build.WIDE
    return ({k: v - wide.get(k, 0) for k, v in cuda_build.COUNTS.items()}
            | {f"{k}_nw12": v for k, v in wide.items()})


def cli_runs(device: str, labels=None) -> dict:
    """The CLI_CASES of `labels` (default: all) through `cli.main(argv)`
    with `--device device`, in a temporary directory: setup (seed 5), prove
    (seed 6), verify, and verify of a copy with a changed public input,
    which must exit 0, 0, 0 and 1. Returns each command's seconds, launches
    and device calls (`device_calls_counted`), the launches of all of them,
    their K1 launches by field, each file's size and sha256, and the
    native verifiers' cells (Groth16 BN254 hash, Marlin BN254 Mini)."""
    import glob
    import hashlib
    import io
    import tempfile

    import torch

    from ckb_zkp_tpu_torch.cli.main import main
    from ckb_zkp_tpu_torch.ops import cuda_build

    out = {"seconds": {}, "launches": {}, "calls": {}, "files": {}, "cells": {}}
    totals = dict.fromkeys(_cli_launches(), 0)
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), k1_by_modulus() as k1:
        for label, setup, prove in CLI_CASES:
            if labels is not None and label not in labels:
                continue
            proof_file = f"proof_files/{'-'.join(prove[:3])}.proof.json"
            steps = ([("setup", ["setup", *setup, "--seed", "5"], 0)] if setup else []) + [
                ("prove", ["prove", *prove, "--seed", "6"], 0),
                ("verify", ["verify", proof_file], 0), ("changed", None, 1)]
            for cmd, argv, want in steps:
                argv = argv or ["verify", _changed_publics(proof_file)]
                cuda_build.reset_counts()
                with device_calls_counted(spartan_sumchecks()) as calls, \
                        contextlib.redirect_stdout(io.StringIO()):
                    t0 = time.perf_counter()
                    rc = main(["--device", device, *argv])
                    if device != "cpu":
                        torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                if rc != want:
                    raise AssertionError(f"CLI {label} {cmd} on {device}: exit {rc}, not {want}")
                key = f"{label} {cmd}"
                launched = _cli_launches()
                out["seconds"][key] = round(dt, 3)
                out["launches"][key] = {k: v for k, v in launched.items() if v}
                out["calls"][key] = {k: v for k, v in calls.items() if v}
                for k, v in launched.items():
                    totals[k] += v
        for path in sorted(glob.glob("setup_files/*") + glob.glob("proof_files/*")):
            with open(path, "rb") as f:
                data = f.read()
            out["files"][path] = [len(data), hashlib.sha256(data).hexdigest()]
        for name, vk, proof_file in (
                ("groth16", "setup_files/groth16-bn254-hash.vk",
                 "proof_files/groth16-bn254-hash.proof.json"),
                ("marlin", "setup_files/marlin-bn254-mini.vk",
                 "proof_files/marlin-bn254-mini.proof.json")):
            if os.path.exists(vk) and os.path.exists(proof_file):
                with open(vk, "rb") as f, open(proof_file) as g:
                    payload = json.load(g)
                    out["cells"][name] = [f.read().hex(), payload["proof"], payload["params"]]
    out["totals"] = totals
    out["k1"] = dict(k1)
    return out


def start_cli_cpu():
    """`cli_runs` on the CPU (the plain versions) in a child process (torch
    on 2 threads), started after the timed kernel rows; `finish_mini_cpu`
    reads its results."""
    import subprocess

    code = ("import json, sys, torch; torch.set_num_threads(2); sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; print(json.dumps(chip_smoke.cli_runs('cpu')))")
    return subprocess.Popen([sys.executable, "-c", code, REPO], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def cli_chain() -> dict:
    """`python3 -m ckb_zkp_tpu_torch.cli.main` setup, prove and verify of
    Groth16 BN254 hash on the card (the default device), then verify of a
    changed public input, each a process of its own in a temporary
    directory: exit codes 0, 0, 0 and 1. Returns each one's seconds."""
    import subprocess
    import tempfile

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    base = [sys.executable, "-m", "ckb_zkp_tpu_torch.cli.main"]
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        proof_file = os.path.join(tmp, "proof_files", "groth16-bn254-hash.proof.json")
        for cmd, argv, want in (
                ("setup", ["setup", "groth16", "bn254", "hash", "--seed", "5"], 0),
                ("prove", ["prove", "groth16", "bn254", "hash", CLI_PREIMAGE, "--seed", "6"], 0),
                ("verify", ["verify", proof_file], 0), ("changed", None, 1)):
            argv = argv or ["verify", _changed_publics(proof_file)]
            t0 = time.perf_counter()
            res = subprocess.run(base + argv, cwd=tmp, env=env, capture_output=True, text=True,
                                 timeout=600)
            seconds[cmd] = round(time.perf_counter() - t0, 3)
            if res.returncode != want:
                raise AssertionError(f"`python3 -m ckb_zkp_tpu_torch.cli.main {' '.join(argv)}` "
                                     f"exited {res.returncode}, not {want}: {res.stderr[-3000:]}")
    return seconds


def native_checks(cells: dict) -> dict:
    """The native C++ verifiers on the CLI's cells: the vk file, the proof
    bytes and the publics give 0, a changed public input 2, a proof cut
    short 1; the contract verifiers give the same codes; both self-tests 0.
    No g++ on the card's host is a failure, not a skip."""
    from ckb_zkp_tpu_torch import contracts, native

    if not native.available():
        raise AssertionError(f"the native verifiers did not build: {native._lib_err}")
    if native.selftest() != 0 or native.marlin_selftest() != 0:
        raise AssertionError("a native self-test failed")
    verifiers = {
        "groth16": (native.groth16_verify_bn254, contracts.universal_groth16_verifier),
        "marlin": (native.marlin_verify_bn254,
                   lambda *c: contracts.universal_marlin_verifier(*c, device=DEVICE))}
    codes = {}
    for name, (run_native, contract) in verifiers.items():
        vk, proof, publics = (bytes.fromhex(x) for x in cells[name])
        changed = bytes([publics[0] ^ 1]) + publics[1:]
        cases = ((vk, proof, publics), (vk, proof, changed), (vk, proof[:-4], publics))
        got = [run_native(*c) for c in cases]
        want = [contract("bn254", *c) for c in cases]
        if got != [0, 2, 1] or want != got:
            raise AssertionError(f"{name}: native codes {got}, contract codes {want}")
        codes[name] = got
    return codes


class Sha256Membership:
    """merkle_tree_sha256.rs, as tests/test_examples.py:117-150 builds it on
    the JAX package's gadgets: in-circuit CBMT membership of leaf `index`
    under the SHA-256 gadget, merge = sha256(left || right); `leaves` None
    gives the setup's shape (`n_lemmas` lemmas)."""

    def __init__(self, p: int, index: int, leaves, n_lemmas: int):
        self.p = p
        self.index = index
        self.leaves = leaves
        self.n_lemmas = n_lemmas

    def generate_constraints(self, cs) -> None:
        from ckb_zkp_tpu_torch.gadgets import cbmt
        from ckb_zkp_tpu_torch.gadgets import sha256 as sh

        hasher = sh.AbstractHashSha256(self.p)
        if self.leaves is not None:
            tree = cbmt.build_merkle_tree(self.leaves, lambda a, b: sh.sha256_native(a + b))
            proof = tree.build_proof(self.index)
            root, leaf = tree.root(), self.leaves[self.index]
            lemmas, tree_index = proof.lemmas, proof.index
        else:
            root = leaf = None
            lemmas = [None] * self.n_lemmas
            tree_index = (1 << self.n_lemmas) - 1 + self.index
        n_root = sh.AbstractHashSha256Output.alloc_input(cs, root)
        n_leaf = sh.AbstractHashSha256Output.alloc(cs, leaf)
        lemma_outs = [sh.AbstractHashSha256Output.alloc(cs, v) for v in lemmas]
        cbmt.MerkleProofGadget(tree_index, lemma_outs, hasher).set_membership(cs, n_root, n_leaf)


def cbmt_run(card: str, n_lemmas: int = CBMT_LEMMAS) -> dict:
    """Groth16 over BN254 on the card for the SHA-256 CBMT membership of
    leaf 7 of a 2^n_lemmas-leaf tree: the synthesis (once: the setup reads
    only the shape's matrices), setup and prove each timed, the proof
    verified against the root's bits and refused with one root bit
    flipped; the setup must launch K6 and the prove K1-K5."""
    import torch

    from ckb_zkp_tpu_torch.gadgets.sha256 import bytes_to_bits_be, sha256_native
    from ckb_zkp_tpu_torch.gadgets import cbmt
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.r1cs import SynthesisMode, synthesize
    from ckb_zkp_tpu_torch.schemes import groth16

    curve = get_curve("bn254")
    p = curve.fr.modulus
    leaves = [bytes([i + 1]) * 32 for i in range(1 << n_lemmas)]
    index = 7
    rng = random.Random(SEED)
    s = {}
    t0 = time.perf_counter()
    shape = synthesize(Sha256Membership(p, index, leaves, n_lemmas), p, SynthesisMode.PROVE)
    s["synthesize"] = time.perf_counter() - t0
    toxic = [rng.randrange(1, p) for _ in range(5)]
    cuda_build.reset_counts()
    t0 = time.perf_counter()
    params = groth16.generate_parameters_from_shape(shape, curve, *toxic, device=DEVICE)
    torch.cuda.synchronize()
    s["setup"] = time.perf_counter() - t0
    setup_launches = dict(cuda_build.COUNTS)
    cuda_build.reset_counts()
    t0 = time.perf_counter()
    proof = groth16.create_proof_from_shape(params, shape, rng.randrange(p), rng.randrange(p))
    torch.cuda.synchronize()
    s["prove"] = time.perf_counter() - t0
    prove_launches = dict(cuda_build.COUNTS)
    root = cbmt.build_merkle_tree(leaves, lambda a, b: sha256_native(a + b)).root()
    bits = [int(b) for b in bytes_to_bits_be(root)]
    pvk = groth16.prepare_verifying_key(curve, params.vk)
    t0 = time.perf_counter()
    ok = groth16.verify_proof(curve, pvk, proof, bits)
    s["verify"] = time.perf_counter() - t0
    flipped = [1 - bits[0]] + bits[1:]
    if not ok or groth16.verify_proof(curve, pvk, proof, flipped):
        raise AssertionError("the CBMT proof does not verify, or a flipped root bit does")
    need = [k for k in ("rcb_fixed_base",) if setup_launches[k] <= 0] + [
        k for k in ("mont_mul", "scan_prefix_madd", "scan_prefix_add", "scan_total_add",
                    "rcb_add") if prove_launches[k] <= 0]
    if need:
        raise AssertionError(f"the CBMT setup and prove did not launch {need}")
    out = {"lemmas": n_lemmas, "leaves": len(leaves), "constraints": shape.num_constraints,
           "variables": shape.num_inputs + shape.num_aux, "domain": params.domain_size,
           "seconds": {k: round(v, 3) for k, v in s.items()},
           "setup_launches": {k: v for k, v in setup_launches.items() if v},
           "prove_launches": {k: v for k, v in prove_launches.items() if v}}
    del params
    torch.cuda.empty_cache()
    return out


def cli_card(card: str) -> dict:
    """The CLI's work on the card: `cli_chain` (four processes through the
    module entry point) in a thread beside `cli_runs` and then the SHA-256
    CBMT circuit (`cbmt_run`), each in this process with its own launch
    counts. Returns their results and seconds."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        chain = pool.submit(cli_chain)
        run = cli_runs(DEVICE)
        runs_s = time.perf_counter() - t0
        cbmt = cbmt_run(card)
        cbmt_s = time.perf_counter() - t0 - runs_s
        chain_s = chain.result()
    return {"run": run, "cbmt": cbmt, "chain_s": chain_s, "runs_s": runs_s, "cbmt_s": cbmt_s,
            "wall_s": time.perf_counter() - t0}


def start_cli_card(card: str):
    """`cli_card` in a child process, started beside the DL phase's (g);
    `phase_cli` reads it."""
    import subprocess

    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "print(json.dumps(chip_smoke.cli_card(sys.argv[2])))")
    return subprocess.Popen([sys.executable, "-c", code, REPO, card], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_cli(card: str, cpu_child, card_child) -> dict:
    """The CLI on the card: `cli_card`'s results from its child process
    (`start_cli_card`); every command's launches against CLI_NEEDS; the
    setup files and proof JSONs (sha256 of each file) equal to the CPU
    child's for the same seeds; the native verifiers on the CLI's cells
    (`native_checks`). Returns the CLI commands' launches (8-word, and
    "_nw12"), their K1 launches by field, and the figures."""
    t0 = time.perf_counter()
    got = finish_run(card_child, "cli")
    wait_s = time.perf_counter() - t0
    run, cbmt = got["run"], got["cbmt"]
    chain_s, runs_s, cbmt_s = got["chain_s"], got["runs_s"], got["cbmt_s"]
    missing = {f"{label} {cmd}": [k for k in need if run["launches"][f"{label} {cmd}"].get(k, 0) <= 0]
               for label, cmds in CLI_NEEDS.items() for cmd, need in cmds.items()}
    missing = {k: v for k, v in missing.items() if v}
    if missing:
        raise AssertionError(f"CLI commands did not launch: {missing}")
    codes = native_checks(run["cells"])
    want = finish_mini_cpu(cpu_child)
    differ = sorted(k for k in set(run["files"]) | set(want["files"])
                    if run["files"].get(k) != want["files"].get(k))
    if differ:
        raise AssertionError(f"CLI files on the card differ from the CPU child's: {differ}")
    log(f"cli chain (python3 -m ckb_zkp_tpu_torch.cli.main, groth16 bn254 hash): exit 0, 0, 0 "
        f"and 1 for a changed public input; seconds {json.dumps(chain_s)} [{card}]")
    log(f"cli seconds: {json.dumps(run['seconds'])} [{card}]")
    log(f"cli launches: {json.dumps(run['launches'])}")
    log(f"cli device calls: {json.dumps({k: v for k, v in run['calls'].items() if v})}")
    log(f"cli files ({len(run['files'])}, bytes and sha256 equal to the CPU child's): "
        f"{json.dumps({k: v[0] for k, v in run['files'].items()})}")
    log(f"cli native verifiers (0 / 2 / 1, equal to the contracts'): {json.dumps(codes)}")
    log(f"cbmt (SHA-256 membership, Groth16 BN254): {json.dumps(cbmt)} [{card}]")
    log(f"cli phase: the child's commands {runs_s:.3f} s wall, then cbmt {cbmt_s:.3f} s "
        f"(the chain beside both), {got['wall_s']:.3f} s in all, read {wait_s:.3f} s after "
        f"the DL phase; the phase {time.perf_counter() - t0:.3f} s [{card}]")
    return {"launches": run["totals"], "k1": run["k1"], "seconds": run["seconds"],
            "chain_s": chain_s, "cbmt": cbmt, "runs_s": runs_s, "cbmt_s": cbmt_s}


def phase_probes(results: dict, log2: int) -> dict:
    """Phase 7: the probes' own checks hold K2a and K2b (G1 and G2), the
    scan probes' kernels P-tot, P-prepk, P-chain (G1, every K and block
    size), P12, P13, P18 and P19 (every block size) against their plain
    versions at edge shapes (flagged leaves and an all-flagged block, 67
    columns, B = 5 tail blocks, one block of B = n = 7), the mxu probe's
    P14-P17, the grid probe's P7-P11 and the dma probe's P20-P22; then
    each kernel against its plain version at the probes' N = 2^log2
    (P14-P17 at the mxu probe's sizes), beside its bound; then the window,
    scan, mxu, grid and dma probes, with the launch counts of that run."""
    import numpy as np
    import torch

    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_build, cuda_probe, cuda_rcb
    from ckb_zkp_tpu_torch.ops.limbs import pack_limbs
    from ckb_zkp_tpu_torch.ops.msm import _RCB_B, device_group
    from ckb_zkp_tpu_torch.probes import dma, grid, mxu, scan, window

    window.check(DEVICE)
    scan.check(DEVICE)
    mxu.check(DEVICE)
    grid.check(DEVICE)
    dma.check(DEVICE)
    log("probes: K2a, K2b (G1, G2), P-tot, P-prepk, P-chain (every K and block "
        "size), P12, P13, P18, P19 (every block size), P14 (every op), P15 "
        "(n_mm 1, 8, 32), P16, P17 (nmul 1, 4), P7-P11 and P20-P22 (every "
        "option) equal to their plain versions at the edge shapes")
    rng = np.random.default_rng(SEED + 7)
    curve = get_curve("bn254")
    record = Recorder(results)
    B, N = _RCB_B, 1 << log2
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        rg, ext = dg.rg, dg.cf.ext
        eb = ext * FQ_BYTES
        X, Y = (rand_field(rng, N, dg.cf.coord_shape, dg.fq) for _ in range(2))
        inf = torch.as_tensor(rng.random(N) < 1 / 1024, device=DEVICE)
        live = N - int(inf.sum())
        packed = (pack_limbs(X.reshape(N, -1)), pack_limbs(Y.reshape(N, -1)))
        for name, args, leaf_bytes in (("scan_prefix_madd_unpacked", (X, Y), 2 * N * eb),
                                       ("scan_prefix_madd_packed", packed, N * eb)):
            kern = getattr(cuda_rcb, name)
            plain = getattr(cuda_rcb, name + "_plain")
            pl, plain_ms = timed_once(lambda: plain(rg, *args, inf, B))
            k = kern(rg, *args, inf, B)
            record(name, max_abs_err(k[0] + k[1], pl[0] + pl[1]),
                   cuda_ms(lambda: kern(rg, *args, inf, B), 3), plain_ms,
                   f"{group} N={N} B={B}, 1/1024 flagged; probe path",
                   (leaf_bytes + N + 3 * N * eb + 3 * (N // B) * eb,
                    live * fq_muls("madd", ext) * IMAD_PER_FQ_MUL))
            del pl, k
        del X, Y, packed, inf
        torch.cuda.empty_cache()

    dg = device_group(curve, "g1", DEVICE)
    xw, yw, inf, x = scan.make_inputs(dg, log2, scan.SEED + 1, DEVICE)
    live = N - int(inf.sum())
    plains = {}
    for name, kern, args, kind in (
            ("probe_madd_totals", cuda_probe.madd_totals, (dg.rg, xw, yw, inf, B), "tot"),
            ("probe_madd_prefix_packed", cuda_probe.madd_prefix_packed,
             (dg.rg, xw, yw, inf, B), "prepk"),
            ("probe_chain_mul", cuda_probe.chain_mul, (dg.fq, x, B), "chain")):
        plain = getattr(cuda_probe, kern.__name__ + "_plain")
        pl, plain_ms = timed_once(lambda: plain(*args))
        plains[kind] = (pl, plain_ms)
        if kind == "prepk":
            pl = pl[0] + pl[1]
        err = 0
        for k in cuda_probe.CHAINS:
            for t in cuda_probe.THREADS:
                out = kern(*args, k, t)
                err = max(err, max_abs_err(out[0] + out[1] if kind == "prepk" else out, pl))
        record(name, err, cuda_ms(lambda: kern(*args, 1, 64), 3), plain_ms,
               f"g1 N={N} B={B}, every K and block size; probe path (ms at K = 1, "
               f"64 threads)", scan.work(kind, N, live))
        del pl, out
    grid_probes(record, dg, xw, yw, inf, B, plains)
    del plains
    tensor_core_probes(record, dg, xw, yw, inf, B)
    del xw, yw, inf, x
    torch.cuda.empty_cache()
    dma_probes(record, N)

    cuda_build.reset_counts()
    win = window.measure(log2, 16, 5, DEVICE)
    sc = scan.measure(log2, 10, DEVICE)
    mx = mxu.measure(10, DEVICE)
    gr = grid.measure(log2, 10, DEVICE)
    dm = dma.measure(log2, 20, DEVICE)
    launches = dict(cuda_build.COUNTS)
    log(f"kernel launches in the probes: {json.dumps(launches)}")
    missing = [k for k in sorted(PROBE_KERNELS) if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the probes: {missing}")
    return {"launches": launches, "window": win, "scan": sc, "mxu": mx, "grid": gr, "dma": dm}


def grid_probes(record, dg, xw, yw, inf, B: int, plains: dict) -> None:
    """P7, P8 (64 and 256 threads) and P11 (32 and 64 columns) on the scan
    probe's leaves against the plain P-tot and P-prepk of the rows above
    (the same functions on the same tensors, so their plain results and
    times are reused), and bit for bit against P-tot's and P-prepk's
    kernels (K = 1, 64 threads); P9 (64 threads) and P10 (32 and 64
    columns) against their plain version, beside the library's two
    `copy_` and one `torch.bitwise_xor`. The table's ms are at 64 threads
    and 32 columns."""
    from ckb_zkp_tpu_torch.ops import cuda_probe as cp
    from ckb_zkp_tpu_torch.probes import grid

    rg, N = dg.rg, xw.shape[0]
    live = N - int(inf.sum())
    (want_t, plain_t), ((want_w, want_tw), plain_w) = plains["tot"], plains["prepk"]
    k_t = cp.madd_totals(rg, xw, yw, inf, B, 1, 64)
    k_w, k_tw = cp.madd_prefix_packed(rg, xw, yw, inf, B, 1, 64)
    errs = {n: 0 for n in ("probe_grid_totals", "probe_grid_prefix", "probe_grid_prefix_tile")}
    runs = [("probe_grid_totals", t, lambda t=t: cp.grid_totals(rg, xw, yw, inf, B, t))
            for t in cp.GRID_THREADS]
    runs += [("probe_grid_prefix", t, lambda t=t: cp.grid_prefix(rg, xw, yw, inf, B, t))
             for t in cp.GRID_THREADS]
    runs += [("probe_grid_prefix_tile", c, lambda c=c: cp.grid_prefix_tile(rg, xw, yw, inf, B, c))
             for c in cp.TILE_COLS]
    for name, opt, fn in runs:
        out = fn()
        got, want, kern = ((out, want_t, k_t) if name == "probe_grid_totals"
                           else (out[0] + out[1], want_w + want_tw, k_w + k_tw))
        errs[name] = max(errs[name], max_abs_err(got, want))
        if max_abs_err(got, kern):
            raise AssertionError(f"{name} != P-tot's / P-prepk's kernel (option {opt})")
        del out, got
    log(f"probes: P7's T equals P-tot's kernel, P8's and P11's W and T P-prepk's, limb "
        f"for limb at N={N}, every option")
    what = f"g1 N={N} B={B}, threads 64, 256 / cols 32, 64; probe path (ms at 64 / 32)"
    for name, kind, plain_ms, fn in (
            ("probe_grid_totals", "tot", plain_t, lambda: cp.grid_totals(rg, xw, yw, inf, B)),
            ("probe_grid_prefix", "prepk", plain_w, lambda: cp.grid_prefix(rg, xw, yw, inf, B)),
            ("probe_grid_prefix_tile", "prepk", plain_w,
             lambda: cp.grid_prefix_tile(rg, xw, yw, inf, B))):
        record(name, errs[name], cuda_ms(fn, 3), plain_ms, what, grid.work(kind, N, live))
    del k_t, k_w, k_tw, want_t, want_w, want_tw
    want, plain_ms = timed_once(lambda: cp.wo_plain(xw, yw))
    lib_ms = cuda_ms(grid.library_wo(xw, yw), 10)
    log(f"library: two copy_ and one torch.bitwise_xor (W of P9/P10) at N={N}: "
        f"{lib_ms:.6f} ms")
    record("probe_wo_steps", max_abs_err(cp.wo_steps(xw, yw, B), want),
           cuda_ms(lambda: cp.wo_steps(xw, yw, B), 10), plain_ms,
           f"g1 N={N} B={B}, 64 threads; probe path; library: two copy_ and one "
           f"torch.bitwise_xor", grid.work("wo", N, live), lib_ms)
    err = max(max_abs_err(cp.wo_tile(xw, yw, B, c), want) for c in cp.TILE_COLS)
    record("probe_wo_tile", err, cuda_ms(lambda: cp.wo_tile(xw, yw, B), 10), plain_ms,
           f"g1 N={N} B={B}, cols 32, 64; probe path (ms at 32); library: two copy_ and "
           f"one torch.bitwise_xor", grid.work("wo", N, live), lib_ms)
    del want


def dma_probes(record, N: int) -> None:
    """P20 (sb 8, 32), P21 and P22 on the dma probe's arrays of N elements
    of 8 words (at least 256 rows of 128), against their plain version, beside one
    `torch.bitwise_xor(a, b, out=o)` on the same arrays. The table's P20 ms
    is at sb 8."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_probe as cp
    from ckb_zkp_tpu_torch.probes import dma

    (a3, b3), (a4, b4) = dma.make_inputs(dma.rows(N), dma.SEED + 1, DEVICE)
    N = a3.shape[1] * dma.LANES
    want3, plain3 = timed_once(lambda: cp.xor_plain(a3, b3))
    want4, plain4 = timed_once(lambda: cp.xor_plain(a4, b4))
    lib3 = cuda_ms(dma.library_xor(a3, b3), 20)
    lib4 = cuda_ms(dma.library_xor(a4, b4), 20)
    log(f"library: torch.bitwise_xor(out=) at {N} x 8 words: {lib3:.6f} ms (Rp, M, 128), "
        f"{lib4:.6f} ms (B, Rp, M/B, 128)")
    what = f"{N} elements x 8 words"
    err = max(max_abs_err(cp.xor_flat(a3, b3, sb), want3) for sb in cp.XOR_SB["flat"])
    record("probe_xor_flat", err, cuda_ms(lambda: cp.xor_flat(a3, b3, 8), 20), plain3,
           f"{what} (Rp, M, 128), sb 8, 32; probe path (ms at sb 8); library: "
           f"torch.bitwise_xor(out=)", dma.work(a3), lib3)
    record("probe_xor_lead1", max_abs_err(cp.xor_lead1(a4, b4, 8), want4),
           cuda_ms(lambda: cp.xor_lead1(a4, b4, 8), 20), plain4,
           f"{what} (B={dma.B}, Rp, M/B, 128), sb 8; probe path", dma.work(a4), lib4)
    record("probe_xor_grid2d", max_abs_err(cp.xor_grid2d(a3, b3, 8, dma.B), want3),
           cuda_ms(lambda: cp.xor_grid2d(a3, b3, 8, dma.B), 20), plain3,
           f"{what} (Rp, M, 128), sb 8, B={dma.B}; probe path", dma.work(a3), lib3)
    del a3, b3, a4, b4, want3, want4
    torch.cuda.empty_cache()


def tensor_core_probes(record, dg, xw, yw, inf, B: int) -> None:
    """P12, P13, P18 and P19 (every block size) on the scan probe's leaves,
    P18 and P19 also bit for bit against P-tot's kernel; P14 (every op), P15
    (n_mm 8, 32) and P16, P17 (nmul 1, 4) at the mxu probe's full sizes, P17
    also against P16; each against its plain version, beside its bound. The
    table's ms are at 64 threads per block, nmul 1 and n_mm 8."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_probe
    from ckb_zkp_tpu_torch.probes import mxu, scan

    rg, N = dg.rg, xw.shape[0]
    live = N - int(inf.sum())
    want_t, plain_t = timed_once(lambda: cuda_probe.madd_totals_plain(rg, xw, yw, inf, B))
    want_w, plain_w = timed_once(lambda: cuda_probe.madd_prefix_packed_plain(
        rg, xw, yw, inf, B))
    k_tot = cuda_probe.madd_totals(rg, xw, yw, inf, B, 1, 64)
    errs = {n: 0 for n in ("probe_gmajor_totals", "probe_gmajor_prefix",
                           "probe_gmajor_totals_tc", "probe_madd_totals_tc")}
    for t in cuda_probe.THREADS:
        g = scan.gmajor_leaves(xw, yw, inf, t, B)
        W, T = cuda_probe.gmajor_prefix(rg, *g, B, t)
        want_g = cuda_probe.to_gmajor(torch.cat(want_w[0], dim=1), B, t)
        outs = {"probe_gmajor_totals": cuda_probe.gmajor_totals(rg, *g, B, t),
                "probe_gmajor_totals_tc": cuda_probe.gmajor_totals(rg, *g, B, t, "tc"),
                "probe_madd_totals_tc": cuda_probe.madd_totals(rg, xw, yw, inf, B, 1, t,
                                                               "tc")}
        errs["probe_gmajor_prefix"] = max(errs["probe_gmajor_prefix"], max_abs_err(
            (W, *T), (want_g, *want_w[1])))
        for name, out in outs.items():
            errs[name] = max(errs[name], max_abs_err(out, want_t))
            if name != "probe_gmajor_totals" and max_abs_err(out, k_tot):
                raise AssertionError(f"{name} != P-tot's kernel (threads={t})")
        del g, W, T, want_g, outs
    log(f"probes: P18 and P19 equal P-tot's kernel limb for limb at N={N}, every "
        f"block size")
    g64 = scan.gmajor_leaves(xw, yw, inf, 64, B)
    what = f"g1 N={N} B={B}, every block size; probe path (ms at 64 threads)"
    for name, kind, plain_ms, fn in (
            ("probe_gmajor_totals", "tot", plain_t,
             lambda: cuda_probe.gmajor_totals(rg, *g64, B, 64)),
            ("probe_gmajor_prefix", "prepk", plain_w,
             lambda: cuda_probe.gmajor_prefix(rg, *g64, B, 64)),
            ("probe_gmajor_totals_tc", "tot_tc", plain_t,
             lambda: cuda_probe.gmajor_totals(rg, *g64, B, 64, "tc")),
            ("probe_madd_totals_tc", "tot_tc", plain_t,
             lambda: cuda_probe.madd_totals(rg, xw, yw, inf, B, 1, 64, "tc"))):
        record(name, errs[name], cuda_ms(fn, 3), plain_ms, what, scan.work(kind, N, live))
    del g64, want_t, want_w, k_tot
    torch.cuda.empty_cache()

    x, x8, a, b = mxu.make_inputs(device=DEVICE)
    n_el = x.numel() // 2
    for op in cuda_probe.U32_OPS:
        pl, plain_ms = timed_once(lambda: cuda_probe.u32_ops_plain(x, op))
        record("probe_u32_ops", max_abs_err(cuda_probe.u32_ops(x, op), pl),
               cuda_ms(lambda: cuda_probe.u32_ops(x, op), 100), plain_ms,
               f"{x.shape[1] // 8} tiles of 8 x 128, op {op}; probe path",
               mxu.work("u32", n_el))
    m2d = cuda_probe.band_mma_matrix(DEVICE)
    tiles = x8.shape[1] // 8
    lib_ms = int_mm_ms(m2d, x8)
    for n_mm in (8, 32):
        pl, plain_ms = timed_once(lambda: cuda_probe.band_mma_plain(m2d, x8, n_mm))
        record("probe_band_mma", max_abs_err(cuda_probe.band_mma(m2d, x8, n_mm), pl),
               cuda_ms(lambda: cuda_probe.band_mma(m2d, x8, n_mm), 5), plain_ms,
               f"{tiles} tiles, n_mm={n_mm}; probe path", mxu.work("band", tiles, n_mm=n_mm),
               lib_ms)
    df = dg.fq
    for nmul in (1, 4):
        outs = {}
        for red in cuda_probe.REDS:
            name = f"probe_mul_chain_{red}"
            pl, plain_ms = timed_once(lambda: cuda_probe.mul_chain_plain(df, a, b, nmul, red))
            outs[red] = cuda_probe.mul_chain(df, a, b, nmul, red)
            record(name, max_abs_err(outs[red], pl),
                   cuda_ms(lambda: cuda_probe.mul_chain(df, a, b, nmul, red), 10), plain_ms,
                   f"fq n={a.shape[0]}, nmul={nmul}; probe path", mxu.work(red, a.shape[0], nmul))
        if max_abs_err(outs["tc"], outs["cios"]):
            raise AssertionError(f"P17 != P16 (nmul={nmul})")
    log(f"probes: P17 equals P16 limb for limb at n={a.shape[0]}, nmul 1 and 4")


def int_mm_ms(m2d, x8):
    """The library yardstick of P15's matmul step alone: one
    `torch._int_mm` of M2d (256, 256) by the whole batch's t8 (256, 128
    tiles), int8 in, int32 out. The port never calls it. None, with a line
    saying so, if the call refuses the shape."""
    import torch

    tiles = x8.shape[1] // 8
    t8 = ((x8 & 0xFF) - 128).to(torch.int8).reshape(32, tiles, 8, 128)
    t8 = t8.permute(0, 2, 1, 3).reshape(256, tiles * 128).contiguous()
    try:
        ms = cuda_ms(lambda: torch._int_mm(m2d, t8), 10)
    except RuntimeError as e:
        log(f"library: torch._int_mm refused (256, 256) x (256, {tiles * 128}): {e}")
        return None
    log(f"library: torch._int_mm (256, 256) x (256, {tiles * 128}) int8: {ms:.6f} ms, "
        f"the matmul of one P15 step alone")
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2", type=int, default=20,
                    help="log2 of the slice's constraint domain (default 20)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    children: list = []
    try:
        return run_phases(args, children)
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()


def run_phases(args, children: list) -> int:
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    card = smi()
    rate = imad_rate()
    log(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"{rate['sms']} SMs, max SM clock {rate['sm_mhz']:.0f} MHz -> "
        f"{rate['imad_per_s']:.4g} IMAD/s for the bounds")
    t0 = time.perf_counter()
    cuda_build.lib()
    log(f"build: {time.perf_counter() - t0:.3f} s wall, nvcc "
        f"{cuda_build.BUILD_INFO.get('seconds', 0.0):.3f} s -> "
        f"{os.path.relpath(cuda_build.BUILD_INFO['path'], REPO)}")
    for line in cuda_build.BUILD_INFO.get("log", "").splitlines():
        if line.startswith("==") or any(
                w in line for w in ("registers", "spill", "Function properties")):
            log(f"nvcc: {line.strip()}")
    results: dict = {}

    t0 = time.perf_counter()
    levels, team, fixed, loop_launches, jac_fixed, jac_shapes, jac_totals = phase_kernels(
        results, args.log2)
    phase_spartan_kernels(results)
    # the CPU children (the Mini proofs from the plain versions), after the
    # timed kernel rows: Marlin and PLONK, Spartan, Bulletproofs/Hyrax/Libra
    cpu_child = start_mini_cpu()
    spartan_child = start_spartan_mini("cpu")
    dl_child = start_dl_mini_cpu()
    cli_child = start_cli_cpu()
    children += [cpu_child, spartan_child, dl_child, cli_child]
    log(f"scan levels (K3, K4 of one window batch at 2^{args.log2}): {json.dumps(levels)}")
    log(f"team shapes (K2, K5 of the prove at 2^{args.log2}, {card}): {json.dumps(team)}")
    log(f"fixed base (K6 at the setup's width 2^{args.log2}, {card}): {json.dumps(fixed)}")
    log(f"jacobian fixed base (K9a at the setup's width 2^{args.log2}, {card}): "
        f"{json.dumps(jac_fixed)}")
    log(f"jacobian shapes (K8 and its chain at the prove's shapes, 2^{args.log2}, {card}): "
        f"{json.dumps(jac_shapes)}")
    log(f"jacobian totals (K9b and K9c at the prove's shapes, 2^{args.log2}, {card}): "
        f"{json.dumps(jac_totals)}")
    t1 = time.perf_counter()
    phase_setup_check(min(14, args.log2))
    t2 = time.perf_counter()
    run = phase_slice(card, args.log2)
    t3 = time.perf_counter()
    jac = phase_jacobian(card, run, args.log2)
    leaf = phase_jacobian_leaf(card)
    t3p = time.perf_counter()
    par = phase_parallel(card, run, args.log2)
    log(f"parallel phase seconds: {json.dumps(par['seconds'])} [{card}]")
    run.pop("params")  # the BN254 keys' device memory, before the BLS12-381 phase
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    # BLS12-381 times its 12-word kernel rows before any other process uses the card
    wide = phase_wide(results, card, args.log2)
    torch.cuda.empty_cache()
    # from here on, child processes run beside this one: the Spartan runs beside
    # Marlin, PLONK and aSVC, the DL children beside the Spartan phase and (g),
    # the CLI's beside (g)
    spartan_runs = start_spartan_runs(card)
    children += spartan_runs.values()
    t5 = time.perf_counter()
    mar = phase_marlin(card, min(MARLIN_LOG2, args.log2))
    torch.cuda.empty_cache()
    kzg_wide = phase_kzg_wide(card, min(KZG_WIDE_LOG2, args.log2))
    torch.cuda.empty_cache()
    log(f"marlin phase seconds: {json.dumps(mar['seconds'])} [{card}]")
    t6 = time.perf_counter()
    plonk = phase_plonk(card, min(PLONK_LOG2, args.log2))
    torch.cuda.empty_cache()
    # the CPU child's Mini proofs, read here, where it has had the Marlin and PLONK phases
    cpu_proofs = phase_marlin_mini(card, cpu_child)
    phase_plonk_reference(card, cpu_proofs["plonk"])
    log(f"plonk phase seconds: {json.dumps(plonk['seconds'])} [{card}]")
    t6s = time.perf_counter()
    asvc_run = phase_asvc(card, min(ASVC_LOG2, args.log2))
    torch.cuda.empty_cache()
    t7 = time.perf_counter()
    dl_runs = start_dl_runs(card)
    children += dl_runs.values()
    spartan = phase_spartan(card, spartan_child, spartan_runs)
    log(f"spartan phase seconds: {json.dumps({k: r['seconds'] for k, r in spartan['runs'].items()})}"
        f" [{card}]")
    t8 = time.perf_counter()
    cli_card_child = start_cli_card(card)
    children.append(cli_card_child)
    dl = phase_dl(card, dl_child, dl_runs)
    torch.cuda.empty_cache()
    log(f"dl phase seconds: {json.dumps({k: r['seconds'] for k, r in dl['runs'].items()})}"
        f" [{card}]")
    t8d = time.perf_counter()
    cli = phase_cli(card, cli_child, cli_card_child)
    t8c = time.perf_counter()
    probes = phase_probes(results, args.log2 + 1)
    t9 = time.perf_counter()
    log(f"phase seconds: kernels {t1 - t0:.3f}, setup check {t2 - t1:.3f}, "
        f"slice {t3 - t2:.3f}, jacobian {t3p - t3:.3f}, parallel {t4 - t3p:.3f}, "
        f"bls12_381 {t5 - t4:.3f}, marlin {t6 - t5:.3f}, plonk {t6s - t6:.3f}, "
        f"asvc {t7 - t6s:.3f}, spartan {t8 - t7:.3f}, dl {t8d - t8:.3f}, cli {t8c - t8d:.3f}, "
        f"probes {t9 - t8c:.3f}; build to the last phase {t9 - t_start:.3f} [{card}]")
    table = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        launches = (probes["launches"] if name in PROBE_KERNELS
                    else loop_launches if name in LOOP_KERNELS
                    else run["setup_launches"] if name in SETUP_KERNELS
                    else jac["setup_launches"] if name in JAC_SETUP_KERNELS
                    else leaf if name in JAC_LEAF_KERNELS
                    else jac["prove_launches"] if name in JAC_PROVE_KERNELS
                    else run["prove_launches"])[name]
        if launches <= 0:
            raise AssertionError(f"{name} was not launched on its path")
        table.append({
            "name": name, "route": "cuda", "source": CSRC + src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
            | ({"marlin_launches": mar["launches"][name],
                "plonk_launches": plonk["launches"][name],
                "parallel_launches": par["p1"]["launches"].get(name, 0)}
               if name in MARLIN_KERNELS else {})
            | ({"spartan_launches": spartan["launches"][name]} if name in SPARTAN_KERNELS
               else {})
            | ({"dl_launches": dl["launches"][name]} if name in DL_KERNELS else {})
            | ({"asvc_launches": asvc_run["fr_mont_mul"]} if name == "mont_mul" else {})
            | {"cli_launches": cli["launches"][name]})
    for row, name in WIDE_ROWS.items():
        r = results[row]
        src, replaces = KERNELS[name]
        # K6 from the setup; K1 from the setup (its normalization) and the
        # timed prove; K2-K5 from the timed prove
        launches = (wide["setup_wide"][name] if name in SETUP_KERNELS
                    else wide["prove_wide"][name]
                    + (wide["setup_wide"][name] if name == "mont_mul" else 0))
        if launches <= 0:
            raise AssertionError(f"{row} was not launched on the BLS12-381 path")
        table.append({
            "name": row, "route": "cuda", "source": CSRC + src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "kzg_launches": kzg_wide[name], "asvc_launches": asvc_run["wide"][name],
            "parallel_launches": sum(g["wide"].get(name, 0) for g in par["p3"].values()),
            "dl_launches": dl["wide"][name], "cli_launches": cli["launches"][row]}
            | ({"plain_rows": r["plain_rows"]} if "plain_rows" in r else {}))
    for row, field_name in (("mont_mul_25519_fq", "curve25519_fq"),
                            ("mont_mul_25519_fr", "curve25519_fr")):
        r = results[row]
        src, replaces = KERNELS["mont_mul"]
        launches = spartan["k1_25519"].get(field_name, 0)  # run (b)'s
        if launches <= 0:
            raise AssertionError(f"{row} was not launched on the curve25519 Spartan path")
        table.append({
            "name": row, "route": "cuda", "source": CSRC + src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
            | ({"dl_launches": dl["k1_25519"].get(field_name, 0)}
               if row == "mont_mul_25519_fq" else {})  # run (e)'s
            | {"cli_launches": cli["k1"].get(field_name, 0)})
    log(card)
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

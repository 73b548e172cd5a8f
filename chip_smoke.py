#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's Groth16 BN254 setup and prover on one GPU.

    python3 chip_smoke.py              # phases at 2^20 (probes 2^21); needs one CUDA card
    python3 chip_smoke.py --log2 14    # the same at a 2^14 slice

Phases: (1) the card, its power limit, SM clock and the torch/CUDA
versions; (2) nvcc builds the kernels from ckb_zkp_tpu_torch/csrc, one
process per source, in parallel; (3) every kernel of the setup's and the
prover's paths (K1-K6) against its plain PyTorch version on the same CUDA
tensors, bit-exact, with both times: at small shapes with edge values, then
at the shapes the slice gives each kernel (K6: the setup's fixed-base
width; K1-K5: the prove's shapes), each beside its bound; the Jacobian
engine's K8, K9a, K9b and K9c the same way (edge cases P = Q, P = -Q,
identity on each side and flagged leaves against the host group, then the
shapes of its 2^log2 setup and prove); and the port's MSM on both engines
against the host-int MSM on a small input; (4) a 2^14 setup check: the
device instance map against the host ints, and the device-branch queries
against the host-mode queries point for point; (5) the slice: the device
setup of a (2^log2 - 2)-constraint square chain with its stage times, one
warm-up and one timed prove, the verifier's verdict on the proof and on a
tampered public input, the kernel launch counts of the setup (K6) and of
the timed prove (K1-K5), and a check that the timed prove leaves no device
memory behind; (6) the same setup and prove on the Jacobian MSM engine
(`_use_rcb = False` on the two cached device groups, restored after):
every query equal to the RCB setup's limb for limb on the rows both hold
(the others at infinity), the proof equal to the RCB proof for the same
(r, s), the verifier's verdicts, and K9a launched by that setup and K8,
K9b and K9c by that prove; (7) the probes (`ckb_zkp_tpu_torch/probes/`):
K2a and K2b (G1, G2) and the scan probes' kernels P-tot, P-prepk and
P-chain (G1, every K and block size) against their plain versions at edge
shapes (the probes' own checks) and at 2^(log2 + 1); the g-major P-tot and
P-prepk (P12, P13) and P-tot on the tensor-core Montgomery reduction
(P18 g-major, P19), at every block size, at edge shapes and at
2^(log2 + 1), P18 and P19 also against P-tot's kernel; the mxu probe's
kernels (P14 u32 op chains, P15 int8 band matmuls, P16 and P17 multiply
chains, CIOS and tensor-core, P17 also against P16) at edge shapes and at
their full sizes; then the window, scan and mxu probes, which must launch
all thirteen.

Bounds: the least time the card could take for a kernel's work at that
shape, the larger of its bytes (each input read once, each output written
once; an Fq element is 16 int32 limbs, 64 B) over 3.35 TB/s and its 32-bit
multiply instructions (an 8-word CIOS product is 2 * 8^2 + 8 word
products, each a low and a high IMAD; Fq2 is 3 Fq products) over 64 IMAD
per SM per clock at the SM's maximum clock, counting the multiplies this
run's data needs (a flagged leaf or an add to infinity needs none), and
int8 tensor-core operations over 1,979 TOPS (P15; the tensor-core
multiply's reduction, whose product counts 2 * 8^2 IMADs); P14's steps
at one op each, at the same 64 per SM per clock. No single PyTorch call computes any of
these functions, so `library_ms` is null, except for P15: one
`torch._int_mm` of its matmul step over the whole batch, a yardstick the
port never calls.

The last line is {"ok": true, "device": {...}}; before it come the card's
name and power limit and one JSON line with the kernel table. Without a
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
    FQ_BYTES, IMAD_PER_FQ_MUL, bound, cuda_ms, fq_muls, imad_rate, max_abs_err,
    rand_field, smi)

SEED = 20261016
DEVICE = "cuda"
CSRC = "ckb_zkp_tpu_torch/csrc/"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "mont_mul": ("mont_mul.cu", "ckb_zkp_tpu/ops/pallas_field.py:323"),
    "scan_prefix_madd": ("rcb_scan.cu", "ckb_zkp_tpu/ops/pallas_rcb.py:248"),
    "scan_prefix_add": ("rcb_scan.cu", "ckb_zkp_tpu/ops/pallas_rcb.py:297"),
    "scan_total_add": ("rcb_scan.cu", "ckb_zkp_tpu/ops/pallas_rcb.py:316"),
    "rcb_add": ("rcb_add.cu", "ckb_zkp_tpu/ops/pallas_rcb.py:193"),
    "rcb_madd": ("rcb_madd.cu", "ckb_zkp_tpu/ops/pallas_rcb.py:204"),
    "ec_add": ("ec_add.cu", "ckb_zkp_tpu/ops/pallas_ec.py:247"),
    "ec_madd": ("ec_madd.cu", "ckb_zkp_tpu/ops/pallas_ec.py:259"),
    "ec_block_totals_madd": ("ec_scan.cu", "ckb_zkp_tpu/ops/pallas_ec.py:271"),
    "ec_block_totals_add": ("ec_scan.cu", "ckb_zkp_tpu/ops/pallas_ec.py:290"),
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
}
# the run whose launches each kernel's row reports
SETUP_KERNELS = {"rcb_madd"}  # the RCB setup
JAC_SETUP_KERNELS = {"ec_madd"}  # the Jacobian engine's setup
JAC_PROVE_KERNELS = {"ec_add", "ec_block_totals_madd", "ec_block_totals_add"}
PROBE_KERNELS = {"scan_prefix_madd_unpacked", "scan_prefix_madd_packed", "probe_madd_totals",
                 "probe_madd_prefix_packed", "probe_chain_mul", "probe_gmajor_totals",
                 "probe_gmajor_prefix", "probe_u32_ops", "probe_band_mma",
                 "probe_mul_chain_cios", "probe_mul_chain_tc", "probe_gmajor_totals_tc",
                 "probe_madd_totals_tc"}  # the probes' runs

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
    launch; K2 scans batch * npad sorted leaves; K3's first level scans the
    batch * npad / 32 block totals; K4's first level and K5 (E = before +
    W[q]) run at batch * nb; K1 multiplies 2^log2 witness rows. The setup:
    K6 runs once per window at the fixed-base width, 2^log2 for G1 and G2.
    The Jacobian engine (8-bit windows, `jb` of them per batch): K9b sums
    jb * npad sorted leaves, K9c their jb * npad / 32 block totals, K8's
    widest launches are the within-block prefixes of jb * nb queries of 32
    rows each, and K9a runs per window on chunks of min(npad, _FB_CHUNK)."""
    from ckb_zkp_tpu_torch.ops import msm

    npad = 1 << log2
    c = msm.DeviceCurveGroup._msm_window_bits(npad)
    nwin = scalar_bits // c
    batch = max(1, min(nwin, msm._WINDOW_BATCH_POINTS // npad))
    nb = 1 << c
    jb = max(1, min(scalar_bits // msm._FIXED_BASE_BITS, msm._WINDOW_BATCH_POINTS // npad))
    jnb = 1 << msm._FIXED_BASE_BITS
    return {"mont_mul": npad, "scan_prefix_madd": batch * npad,
            "scan_prefix_add": batch * npad // msm._RCB_B,
            "scan_total_add": batch * nb, "rcb_add": batch * nb, "rcb_madd": npad,
            "ec_add": jb * jnb * msm._SCAN_B, "ec_madd": min(npad, msm._FB_CHUNK),
            "ec_block_totals_madd": jb * npad,
            "ec_block_totals_add": jb * npad // msm._SCAN_B}


class Recorder:
    """Kernel-vs-plain comparisons. The kernel table keeps the times and
    the bound of each kernel's first comparison at a main-path shape."""

    def __init__(self, results: dict):
        self.results = results

    def __call__(self, name, err, ms, plain_ms, what, work=None, library_ms=None):
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


def phase_kernels(results: dict, log2: int) -> None:
    import numpy as np
    import torch

    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_rcb
    from ckb_zkp_tpu_torch.ops.msm import _RCB_B, device_group

    rng = np.random.default_rng(SEED)
    curve = get_curve("bn254")
    record = Recorder(results)

    # K1 at 2^16 Fr and Fq elements with 0, 1, p - 1 and R mod p
    n = 1 << 16
    g1 = device_group(curve, "g1", DEVICE)
    for fname, df in (("fr", g1.fr), ("fq", g1.fq)):
        p = df.spec.modulus
        a = rand_field(rng, n, (df.L,), df)
        b = rand_field(rng, n, (df.L,), df)
        a[:4] = df.encode([0, 1, p - 1, df.R])
        b[:4] = df.encode([p - 1, p - 1, p - 1, df.R])
        k = df.mul(a, b)
        pl = df.plain.mul(a, b)
        torch.cuda.synchronize()
        if df.decode(k[:4]) != [0, p - 1, 1, df.R * df.R % p]:
            raise AssertionError(f"mont_mul edge values wrong ({fname})")
        record("mont_mul", max_abs_err(k, pl),
               cuda_ms(lambda: df.mul(a, b), 50),
               cuda_ms(lambda: df.plain.mul(a, b), 5), f"bn254 {fname} n=2^16")

    # K5 and K6 at 2^14 G1 and G2 points with P+P, P+(-P), identity
    # operands and (K6) flagged leaves, checked against the host group
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
            raise AssertionError(f"rcb_add edge cases wrong ({group})")
        record("rcb_add", max_abs_err(k, pl),
               cuda_ms(lambda: rg.add(P, Q), 20),
               cuda_ms(lambda: cuda_rcb.rcb_add_plain(rg, P, Q), 2), f"{group} n=2^14")
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

    # the scan in all three modes at N = 2^15 (B = 32) and at a tail B = 5
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        rg, cs = dg.rg, dg.cf.coord_shape
        for N, B in ((1 << 15, 32), (5 * 64, 5)):
            X = rand_field(rng, N, cs, dg.fq)
            Y = rand_field(rng, N, cs, dg.fq)
            inf = torch.as_tensor(rng.random(N) < 0.1, device=DEVICE)
            xw, yw = cuda_rcb.pack_limbs_flag(rg, X, Y, inf)
            pts = tuple(rand_field(rng, N, cs, dg.fq) for _ in range(3))
            what = f"{group} N={N} B={B}"
            k = cuda_rcb.scan_prefix_madd(rg, xw, yw, B)
            pl = cuda_rcb.scan_prefix_madd_plain(rg, xw, yw, B)
            torch.cuda.synchronize()
            record("scan_prefix_madd", max_abs_err(k[0] + k[1], pl[0] + pl[1]),
                   cuda_ms(lambda: cuda_rcb.scan_prefix_madd(rg, xw, yw, B), 5),
                   cuda_ms(lambda: cuda_rcb.scan_prefix_madd_plain(rg, xw, yw, B), 1), what)
            k = cuda_rcb.scan_prefix_add(rg, pts, B)
            pl = cuda_rcb.scan_prefix_add_plain(rg, pts, B)
            torch.cuda.synchronize()
            record("scan_prefix_add", max_abs_err(k[0] + k[1], pl[0] + pl[1]),
                   cuda_ms(lambda: cuda_rcb.scan_prefix_add(rg, pts, B), 5),
                   cuda_ms(lambda: cuda_rcb.scan_prefix_add_plain(rg, pts, B), 1), what)
            k = cuda_rcb.scan_total_add(rg, pts, B)
            pl = cuda_rcb.scan_total_add_plain(rg, pts, B)
            torch.cuda.synchronize()
            record("scan_total_add", max_abs_err(k, pl),
                   cuda_ms(lambda: cuda_rcb.scan_total_add(rg, pts, B), 5),
                   cuda_ms(lambda: cuda_rcb.scan_total_add_plain(rg, pts, B), 1), what)

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
    B = _RCB_B
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        rg, cs, ext = dg.rg, dg.cf.coord_shape, dg.cf.ext
        eb = ext * FQ_BYTES  # bytes of one coordinate
        # K6 at the setup's fixed-base width, flags as often as a zero digit
        n = sizes["rcb_madd"]
        P = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
        leaves = (rand_field(rng, n, cs, dg.fq), rand_field(rng, n, cs, dg.fq),
                  torch.as_tensor(rng.random(n) < 1 / 256, device=DEVICE))
        live = n - int(leaves[2].sum())
        pl, plain_ms = timed_once(
            lambda: chunked_plain(cuda_rcb.rcb_madd_plain, rg, P, leaves))
        record("rcb_madd", max_abs_err(rg.madd(P, leaves), pl),
               cuda_ms(lambda: rg.madd(P, leaves), 5), plain_ms,
               f"{group} n={n}; main path (setup)",
               (6 * n * eb + 2 * live * eb + n,
                live * fq_muls("madd", ext) * IMAD_PER_FQ_MUL))
        del P, leaves, pl
        n = sizes["rcb_add"]
        P = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
        Q = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
        pl, plain_ms = timed_once(lambda: chunked_plain(cuda_rcb.rcb_add_plain, rg, P, Q))
        record("rcb_add", max_abs_err(rg.add(P, Q), pl),
               cuda_ms(lambda: rg.add(P, Q), 5), plain_ms,
               f"{group} n={n}; main path",
               (9 * n * eb, n * fq_muls("add", ext) * IMAD_PER_FQ_MUL))
        N = sizes["scan_prefix_madd"]
        X = rand_field(rng, N, cs, dg.fq)
        Y = rand_field(rng, N, cs, dg.fq)
        inf = torch.as_tensor(rng.random(N) < 0.01, device=DEVICE)
        live = N - int(inf.sum())
        xw, yw = cuda_rcb.pack_limbs_flag(rg, X, Y, inf)
        del X, Y
        pl, plain_ms = timed_once(lambda: cuda_rcb.scan_prefix_madd_plain(rg, xw, yw, B))
        k = cuda_rcb.scan_prefix_madd(rg, xw, yw, B)
        record("scan_prefix_madd", max_abs_err(k[0] + k[1], pl[0] + pl[1]),
               cuda_ms(lambda: cuda_rcb.scan_prefix_madd(rg, xw, yw, B), 3), plain_ms,
               f"{group} N={N} B={B}; main path",
               (N * eb + 3 * N * eb + 3 * (N // B) * eb,
                live * fq_muls("madd", ext) * IMAD_PER_FQ_MUL))
        del xw, yw, k, pl
        for name, N in (("scan_prefix_add", sizes["scan_prefix_add"]),
                        ("scan_total_add", sizes["scan_total_add"])):
            pts = tuple(rand_field(rng, N, cs, dg.fq) for _ in range(3))
            kern = getattr(cuda_rcb, name)
            plain = getattr(cuda_rcb, name + "_plain")
            pl, plain_ms = timed_once(lambda: plain(rg, pts, B))
            k = kern(rg, pts, B)
            w_out = 3 * N * eb if name == "scan_prefix_add" else 0
            if name == "scan_prefix_add":
                k, pl = k[0] + k[1], pl[0] + pl[1]
            record(name, max_abs_err(k, pl), cuda_ms(lambda: kern(rg, pts, B), 3),
                   plain_ms, f"{group} N={N} B={B}; main path",
                   (3 * N * eb + w_out + 3 * (N // B) * eb,
                    N * fq_muls("add", ext) * IMAD_PER_FQ_MUL))
    torch.cuda.empty_cache()
    jacobian_kernels(record, rng, curve, sizes)
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
    """K8, K9a, K9b and K9c against their plain versions: at 2^14 with the
    edge cases (P = Q, P = -Q, identity on each side, flagged leaves, with
    general-Z accumulators) also against the host group; the scans at
    N = 2^15 (B = 32, repeated leaves for the doubling branch) and a tail
    B = 5; then at the shapes of the Jacobian setup and prove."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_ec, ec
    from ckb_zkp_tpu_torch.ops.msm import _SCAN_B, device_group

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
        for N, B in ((1 << 15, _SCAN_B), (5 * 64, 5)):
            X, Y = rand_field(rng, N, cs, dg.fq), rand_field(rng, N, cs, dg.fq)
            flags = torch.as_tensor(rng.random(N) < 0.1, device=DEVICE)
            X[1], Y[1], flags[:2] = X[0], Y[0], False  # leaf 0 twice: a doubling
            pts = tuple(rand_field(rng, N, cs, dg.fq) for _ in range(3))
            for c in pts:
                c[1] = c[0]
            what = f"{group} N={N} B={B}"
            for name, args in (("ec_block_totals_madd", ((X, Y, flags), B)),
                               ("ec_block_totals_add", (pts, B))):
                kern = getattr(cuda_ec, name[3:])
                plain = getattr(cuda_ec, name[3:] + "_plain")
                pl, plain_ms = timed_once(lambda: plain(cf, *args))
                record(name, max_abs_err(kern(cf, *args), pl),
                       cuda_ms(lambda: kern(cf, *args), 5), plain_ms, what)

    # the shapes of the 2^log2 Jacobian setup and prove; plain timed once
    B = _SCAN_B
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
               f"{group} n={n}, 1/256 flagged; main path (setup)",
               (8 * n * eb + n, live * fq_muls("jmadd", ext) * IMAD_PER_FQ_MUL))
        del P, Q, leaves, pl
        N = sizes["ec_block_totals_madd"]
        lv = (rand_field(rng, N, cs, dg.fq), rand_field(rng, N, cs, dg.fq),
              torch.as_tensor(rng.random(N) < 0.01, device=DEVICE))
        live = (~lv[2]).reshape(N // B, B)
        adds = int(live.sum()) - int(live.any(1).sum())  # the first live leaf copies
        pl, plain_ms = timed_once(lambda: cuda_ec.block_totals_madd_plain(cf, lv, B))
        record("ec_block_totals_madd", max_abs_err(cuda_ec.block_totals_madd(cf, lv, B), pl),
               cuda_ms(lambda: cuda_ec.block_totals_madd(cf, lv, B), 3), plain_ms,
               f"{group} N={N} B={B}; main path (prove)",
               (N * 2 * eb + N + 3 * (N // B) * eb,
                adds * fq_muls("jmadd", ext) * IMAD_PER_FQ_MUL))
        del lv, pl
        N = sizes["ec_block_totals_add"]
        pts = tuple(rand_field(rng, N, cs, dg.fq) for _ in range(3))
        pl, plain_ms = timed_once(lambda: cuda_ec.block_totals_add_plain(cf, pts, B))
        record("ec_block_totals_add", max_abs_err(cuda_ec.block_totals_add(cf, pts, B), pl),
               cuda_ms(lambda: cuda_ec.block_totals_add(cf, pts, B), 3), plain_ms,
               f"{group} N={N} B={B}; main path (prove)",
               (3 * N * eb + 3 * (N // B) * eb,
                (N - N // B) * fq_muls("jadd", ext) * IMAD_PER_FQ_MUL))


def phase_setup_check(log2: int) -> None:
    """The device setup of a (2^log2 - 2)-constraint square chain against
    the host-int instance map and the host-mode setup, point for point."""
    import torch

    from ckb_zkp_tpu_torch.bench_circuits import square_chain_shape
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.schemes import groth16
    from ckb_zkp_tpu_torch.schemes.groth16.qap import qap_matrices

    curve = get_curve("bn254")
    fr = curve.fr.modulus
    prng = random.Random(SEED + 1)
    shape = square_chain_shape((1 << log2) - 2, fr, seed=SEED % 997)
    toxic = [prng.randrange(1, fr) for _ in range(5)]
    qap = qap_matrices(shape, curve.fr, DEVICE)
    nv = shape.num_variables
    got = tuple(qap.df.decode(x[:nv]) for x in qap.evaluations_at(toxic[-1]))
    if got != qap.evaluations_at_host(toxic[-1]):
        raise AssertionError("device instance map != host instance map")
    log(f"setup check 2^{log2}: device instance map (u, v, w) equals the host ints")
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
        log(f"setup check 2^{log2}: {name} {n} points equal, "
            f"{d[0].shape[0] - n} padding rows at infinity")
    if dev.vk != host.vk:
        raise AssertionError("device-branch and host-mode verifying keys differ")


def phase_slice(card: str, log2: int) -> dict:
    """Device setup, warm-up prove, timed prove and verdicts of the
    (2^log2 - 2)-constraint square chain. Returns the run (curve, shape,
    toxic waste, parameters, r, s, proof) with the kernel launches of the
    setup and of the timed prove."""
    import torch

    from ckb_zkp_tpu_torch.bench_circuits import square_chain_shape
    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_build
    from ckb_zkp_tpu_torch.schemes import groth16

    curve = get_curve("bn254")
    fr = curve.fr.modulus
    prng = random.Random(SEED)
    t0 = time.perf_counter()
    shape = square_chain_shape((1 << log2) - 2, fr, seed=SEED % 1000)
    log(f"slice: square_chain_shape((1 << {log2}) - 2): m = 2^{log2}, "
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
    log(f"setup: {setup_s:.3f} s {json.dumps(setup_t)} [{card}]")
    log(f"kernel launches in the setup: {json.dumps(setup_launches)}")
    if setup_launches["rcb_madd"] <= 0:
        raise AssertionError("the setup did not launch K6 (rcb_madd)")
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
    peak = torch.cuda.max_memory_allocated()
    after = torch.cuda.memory_allocated()
    log(f"timed prove: {prove_s:.3f} s, peak device memory {peak} bytes [{card}]")
    log(f"device memory held: {held} bytes after the warm-up prove, {after} "
        f"after the timed prove")
    if after > held + (1 << 20):
        raise AssertionError("a prove left device memory behind")
    log(f"prove stages (s): {json.dumps(stages)} [{card}]")
    log(f"kernel launches in the timed prove: {json.dumps(launches)}")
    rcb_prove = (set(KERNELS) - SETUP_KERNELS - JAC_SETUP_KERNELS - JAC_PROVE_KERNELS
                 - PROBE_KERNELS)
    missing = [k for k in sorted(rcb_prove) if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the prove: {missing}")
    check_verdicts(curve, params, shape, proof)
    return {"curve": curve, "shape": shape, "toxic": toxic, "params": params,
            "r": r, "s": s, "proof": proof, "setup_launches": setup_launches,
            "prove_launches": launches}


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
        if setup_launches["ec_madd"] <= 0:
            raise AssertionError("the Jacobian setup did not launch K9a (ec_madd)")
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
    log(f"jacobian prove: {prove_s:.3f} s {json.dumps(stages)} [{card}]")
    log(f"kernel launches in the jacobian prove: {json.dumps(launches)}")
    missing = [k for k in sorted(JAC_PROVE_KERNELS) if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the Jacobian prove: {missing}")
    want = run["proof"]
    if (proof.a, proof.b, proof.c) != (want.a, want.b, want.c):
        raise AssertionError("the Jacobian engine's proof != the RCB engine's")
    log("jacobian prove: the proof equals the RCB engine's for the same (r, s)")
    check_verdicts(curve, params, shape, proof)
    return {"setup_launches": setup_launches, "prove_launches": launches}


def phase_probes(results: dict, log2: int) -> dict:
    """Phase 7: the probes' own checks hold K2a and K2b (G1 and G2), the
    scan probes' kernels P-tot, P-prepk, P-chain (G1, every K and block
    size), P12, P13, P18 and P19 (every block size) against their plain
    versions at edge shapes (flagged leaves and an all-flagged block, 67
    columns, B = 5 tail blocks, one block of B = n = 7), and the mxu
    probe's P14-P17; then each kernel against its plain version at the
    probes' N = 2^log2 (P14-P17 at the mxu probe's sizes), beside its
    bound; then the window, scan and mxu probes, with the launch counts of
    that run."""
    import numpy as np
    import torch

    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_build, cuda_probe, cuda_rcb
    from ckb_zkp_tpu_torch.ops.limbs import pack_limbs
    from ckb_zkp_tpu_torch.ops.msm import _RCB_B, device_group
    from ckb_zkp_tpu_torch.probes import mxu, scan, window

    window.check(DEVICE)
    scan.check(DEVICE)
    mxu.check(DEVICE)
    log("probes: K2a, K2b (G1, G2), P-tot, P-prepk, P-chain (every K and block "
        "size), P12, P13, P18, P19 (every block size), P14 (every op), P15 "
        "(n_mm 1, 8, 32) and P16, P17 (nmul 1, 4) equal to their plain versions "
        "at the edge shapes")
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
    for name, kern, args, kind in (
            ("probe_madd_totals", cuda_probe.madd_totals, (dg.rg, xw, yw, inf, B), "tot"),
            ("probe_madd_prefix_packed", cuda_probe.madd_prefix_packed,
             (dg.rg, xw, yw, inf, B), "prepk"),
            ("probe_chain_mul", cuda_probe.chain_mul, (dg.fq, x, B), "chain")):
        plain = getattr(cuda_probe, kern.__name__ + "_plain")
        pl, plain_ms = timed_once(lambda: plain(*args))
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
    tensor_core_probes(record, dg, xw, yw, inf, B)
    del xw, yw, inf, x
    torch.cuda.empty_cache()

    cuda_build.reset_counts()
    win = window.measure(log2, 16, 5, DEVICE)
    sc = scan.measure(log2, 10, DEVICE)
    mx = mxu.measure(10, DEVICE)
    launches = dict(cuda_build.COUNTS)
    log(f"kernel launches in the probes: {json.dumps(launches)}")
    missing = [k for k in sorted(PROBE_KERNELS) if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the probes: {missing}")
    return {"launches": launches, "window": win, "scan": sc, "mxu": mx}


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
    from ckb_zkp_tpu_torch.ops import cuda_build

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
    phase_kernels(results, args.log2)
    t1 = time.perf_counter()
    phase_setup_check(min(14, args.log2))
    t2 = time.perf_counter()
    run = phase_slice(card, args.log2)
    t3 = time.perf_counter()
    jac = phase_jacobian(card, run, args.log2)
    t4 = time.perf_counter()
    probes = phase_probes(results, args.log2 + 1)
    t5 = time.perf_counter()
    log(f"phase seconds: kernels {t1 - t0:.3f}, setup check {t2 - t1:.3f}, "
        f"slice {t3 - t2:.3f}, jacobian {t4 - t3:.3f}, probes {t5 - t4:.3f} [{card}]")
    table = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        launches = (probes["launches"] if name in PROBE_KERNELS
                    else run["setup_launches"] if name in SETUP_KERNELS
                    else jac["setup_launches"] if name in JAC_SETUP_KERNELS
                    else jac["prove_launches"] if name in JAC_PROVE_KERNELS
                    else run["prove_launches"])[name]
        if launches <= 0:
            raise AssertionError(f"{name} was not launched on its path")
        table.append({
            "name": name, "route": "cuda", "source": CSRC + src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(card)
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's Groth16 BN254 prover once on one GPU.

    python3 chip_smoke.py              # all phases; needs one CUDA card
    python3 chip_smoke.py --log2 14    # the same at a 2^14 slice

Phases: (1) the card, its power limit and the torch/CUDA versions;
(2) nvcc builds the kernels from ckb_zkp_tpu_torch/csrc; (3) every kernel
of the prover's path (K1-K5) against its plain PyTorch version on the
same CUDA tensors, bit-exact, with both times: at small shapes with edge
values, then at the shapes the slice's prove gives each kernel; and the
port's MSM against the host-int MSM on a small input; (4) the slice: port
setup, one warm-up and one timed prove of a 2^18-constraint square chain,
the reference verifier's verdict on the proof and on a tampered public
input, the kernel launch counts of the timed prove, and a check that the
timed prove leaves no device memory behind.

The last line is {"ok": true, "device": {...}}; before it come the card's
name and power limit and one JSON line with the kernel table. Without a
CUDA device, or without the rest of the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
DEVICE = "cuda"
SOURCE = "ckb_zkp_tpu_torch/csrc/zkp_kernels.cu"
REPLACES = {
    "mont_mul": "ckb_zkp_tpu/ops/pallas_field.py:323",
    "scan_prefix_madd": "ckb_zkp_tpu/ops/pallas_rcb.py:248",
    "scan_prefix_add": "ckb_zkp_tpu/ops/pallas_rcb.py:297",
    "scan_total_add": "ckb_zkp_tpu/ops/pallas_rcb.py:316",
    "rcb_add": "ckb_zkp_tpu/ops/pallas_rcb.py:193",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events, after a warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a, b) -> int:
    """Largest limb difference over tuples of int32 tensors (0 = bit-equal)."""
    if not isinstance(a, (tuple, list)):
        a, b = (a,), (b,)
    return max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b))


def rand_field(rng, n: int, shape_tail, df):
    """n random canonical field elements (limbs below p's top limb)."""
    import numpy as np
    import torch

    L = df.L
    arr = rng.integers(0, 1 << 16, size=(n, *shape_tail[:-1], L), dtype=np.int64)
    arr[..., -1] = rng.integers(0, int(df.p_limbs[-1]), size=arr.shape[:-1])
    return torch.as_tensor(arr.astype(np.int32), device=DEVICE)


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


def chunked_plain_add(rg, P, Q, chunk: int = 1 << 16):
    """K5's plain version in chunks of points, to bound its int64 and
    float64 temporaries; the add is elementwise, so the values are the
    same as one call's."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_rcb

    parts = [
        cuda_rcb.rcb_add_plain(rg, tuple(c[i : i + chunk] for c in P),
                               tuple(c[i : i + chunk] for c in Q))
        for i in range(0, P[0].shape[0], chunk)
    ]
    return tuple(torch.cat(cs, dim=0) for cs in zip(*parts))


def path_shapes(log2: int, scalar_bits: int) -> dict:
    """Element counts each kernel gets from the 2^log2 square-chain prove,
    derived from the MSM's own rules (`ops/msm.py`): every MSM has
    npad = 2^log2 points and runs `batch` windows of nb buckets per launch.
    K2 scans batch * npad sorted leaves; K3's first level scans the
    batch * npad / 32 block totals; K4's first level and K5 (E = before +
    W[q]) run at batch * nb; K1 multiplies 2^log2 witness rows."""
    from ckb_zkp_tpu_torch.ops import msm

    npad = 1 << log2
    c = msm.DeviceCurveGroup._msm_window_bits(npad)
    nwin = scalar_bits // c
    batch = max(1, min(nwin, msm._WINDOW_BATCH_POINTS // npad))
    nb = 1 << c
    return {"mont_mul": npad, "scan_prefix_madd": batch * npad,
            "scan_prefix_add": batch * npad // msm._RCB_B,
            "scan_total_add": batch * nb, "rcb_add": batch * nb}


def phase_kernels(results: dict, log2: int) -> None:
    import numpy as np
    import torch

    from ckb_zkp_tpu_torch._reference import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_rcb
    from ckb_zkp_tpu_torch.ops.msm import _RCB_B, device_group

    rng = np.random.default_rng(SEED)
    curve = get_curve("bn254")

    def record(name, err, ms, plain_ms, what, path=False):
        """One comparison; the kernel table keeps the times of the first
        comparison at a main-path shape."""
        log(f"kernel {name} [{what}]: max_abs_err={err} kernel_ms={ms:.6f} "
            f"plain_ms={plain_ms:.6f}")
        if err != 0:
            raise AssertionError(f"{name} disagrees with its plain version ({what})")
        r = results.setdefault(name, {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if path and "ms" not in r:
            r["ms"], r["plain_ms"] = ms, plain_ms

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

    # K5 at 2^14 G1 and G2 points with P+P, P+(-P) and identity operands
    n = 1 << 14
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        rg, cs, host = dg.rg, dg.cf.coord_shape, dg.host_group
        gen = curve.g1_gen if group == "g1" else curve.g2_gen
        r0, r1, r2, r3 = (host.mul(gen, int(x)) for x in rng.integers(2, 1 << 60, 4))
        inf = host.infinity
        left = [r0, r1, inf, r3, inf, r1]
        right = [r0, host.neg(r1), r2, inf, inf, r2]
        P = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
        Q = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
        for full, edge in ((P, rg.from_affine_enc(dg.encode_points(left))),
                           (Q, rg.from_affine_enc(dg.encode_points(right)))):
            for c_full, c_edge in zip(full, edge):
                c_full[: len(left)] = c_edge
        k = rg.add(P, Q)
        pl = cuda_rcb.rcb_add_plain(rg, P, Q)
        torch.cuda.synchronize()
        got = dg.decode_points_host(rg.to_jacobian(tuple(c[: len(left)] for c in k)))
        if got != [host.add(x, y) for x, y in zip(left, right)]:
            raise AssertionError(f"rcb_add edge cases wrong ({group})")
        record("rcb_add", max_abs_err(k, pl),
               cuda_ms(lambda: rg.add(P, Q), 20),
               cuda_ms(lambda: cuda_rcb.rcb_add_plain(rg, P, Q), 2), f"{group} n=2^14")

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

    # every kernel at the shapes the slice's prove gives it, K1 also with
    # a broadcast constant operand (to_mont/from_mont read it with step 0);
    # the plain side runs once, timed by that call
    sizes = path_shapes(log2, g1.fr.L * 16)
    n = sizes["mont_mul"]
    df = g1.fr
    a = rand_field(rng, n, (df.L,), df)
    b = rand_field(rng, n, (df.L,), df)
    for what, kf, pf in (
        ("a*b", lambda: df.mul(a, b), lambda: df.plain.mul(a, b)),
        ("to_mont, step 0", lambda: df.to_mont(a), lambda: df.plain.to_mont(a)),
        ("from_mont, step 0", lambda: df.from_mont(a), lambda: df.plain.from_mont(a)),
    ):
        pl, plain_ms = timed_once(pf)
        record("mont_mul", max_abs_err(kf(), pl), cuda_ms(kf, 10), plain_ms,
               f"bn254 fr n={n} {what}; main path", path=True)
    for group in ("g1", "g2"):
        dg = device_group(curve, group, DEVICE)
        rg, cs = dg.rg, dg.cf.coord_shape
        n = sizes["rcb_add"]
        P = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
        Q = tuple(rand_field(rng, n, cs, dg.fq) for _ in range(3))
        pl, plain_ms = timed_once(lambda: chunked_plain_add(rg, P, Q))
        record("rcb_add", max_abs_err(rg.add(P, Q), pl),
               cuda_ms(lambda: rg.add(P, Q), 5), plain_ms,
               f"{group} n={n}; main path", path=True)
        B = _RCB_B
        N = sizes["scan_prefix_madd"]
        X = rand_field(rng, N, cs, dg.fq)
        Y = rand_field(rng, N, cs, dg.fq)
        inf = torch.as_tensor(rng.random(N) < 0.01, device=DEVICE)
        xw, yw = cuda_rcb.pack_limbs_flag(rg, X, Y, inf)
        del X, Y
        pl, plain_ms = timed_once(lambda: cuda_rcb.scan_prefix_madd_plain(rg, xw, yw, B))
        k = cuda_rcb.scan_prefix_madd(rg, xw, yw, B)
        record("scan_prefix_madd", max_abs_err(k[0] + k[1], pl[0] + pl[1]),
               cuda_ms(lambda: cuda_rcb.scan_prefix_madd(rg, xw, yw, B), 3), plain_ms,
               f"{group} N={N} B={B}; main path", path=True)
        del xw, yw, k, pl
        for name, N in (("scan_prefix_add", sizes["scan_prefix_add"]),
                        ("scan_total_add", sizes["scan_total_add"])):
            pts = tuple(rand_field(rng, N, cs, dg.fq) for _ in range(3))
            kern = getattr(cuda_rcb, name)
            plain = getattr(cuda_rcb, name + "_plain")
            pl, plain_ms = timed_once(lambda: plain(rg, pts, B))
            k = kern(rg, pts, B)
            if name == "scan_prefix_add":
                k, pl = k[0] + k[1], pl[0] + pl[1]
            record(name, max_abs_err(k, pl), cuda_ms(lambda: kern(rg, pts, B), 3),
                   plain_ms, f"{group} N={N} B={B}; main path", path=True)
    torch.cuda.empty_cache()

    # the port's MSM against the host-int MSM on a small input
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
        got = dg.decode_point(dg.msm(dg.encode_points(pts), dg.encode_scalars(sc)))
        if got != host.msm(pts, sc):
            raise AssertionError(f"port MSM != host MSM ({group}, n={n})")
        log(f"msm {group} n={n}: equal to the host-int MSM")


def phase_slice(card: str, log2: int) -> dict:
    import torch

    from ckb_zkp_tpu_torch._reference import get_curve, square_chain_shape
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
    t0 = time.perf_counter()
    params = groth16.generate_parameters_from_shape(
        shape, curve, *toxic, device=DEVICE, timings=setup_t)
    setup_s = time.perf_counter() - t0
    log(f"setup: {setup_s:.3f} s {json.dumps(setup_t)} [{card}]")
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
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the prove: {missing}")
    pvk = groth16.prepare_verifying_key(curve, params.vk)
    publics = shape.input_assignment[1:]
    ok = groth16.verify_proof(curve, pvk, proof, publics)
    bad = groth16.verify_proof(curve, pvk, proof, [(publics[0] + 1) % fr])
    log(f"verify_proof: {ok}; tampered public input: {bad}")
    if ok is not True or bad is not False:
        raise AssertionError("the proof does not verify, or a tampered one does")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2", type=int, default=18,
                    help="log2 of the slice's constraint domain (default 18)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from ckb_zkp_tpu_torch.ops import cuda_build

    card = smi()
    log(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    cuda_build.lib()
    log(f"build: {time.perf_counter() - t0:.3f} s wall, nvcc "
        f"{cuda_build.BUILD_INFO.get('seconds', 0.0):.3f} s -> "
        f"{os.path.relpath(cuda_build.BUILD_INFO['path'], REPO)}")
    for line in cuda_build.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Function properties" in line:
            log(f"nvcc: {line.strip()}")

    results: dict = {}
    phase_kernels(results, args.log2)
    launches = phase_slice(card, args.log2)
    table = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
        for name in REPLACES
    ]
    log(card)
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

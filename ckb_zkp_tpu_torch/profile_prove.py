"""Time and profile the port's Groth16 prove (or setup) on one CUDA card.

    python -m ckb_zkp_tpu_torch.profile_prove [--log2 20] [--reps 10] [--setup]
        [--engine rcb|jacobian]

Runs the port's setup for a (2^log2 - 2)-constraint square chain, one
warm-up prove, `reps` timed proves (median and quartiles of the wall
clock, each ending in a synchronize; the largest peak of device memory
among them; the device memory held before and after them), then one prove
under torch.profiler: the device's busy time (sum of kernel self times),
its idle share of the wall clock, the launches and device time of torch's
row-read kernels (names holding "gather" or "index": the gathers and
indexing of table or leaf rows), each such kernel by name, and the 40
kernels with the most device time, and the port's own kernels grouped by
launch shape (grid and block, from the trace's kernel records): each
shape's launches and device ms. With `--setup` the timed and profiled
runs are setups instead (no prove). `--engine jacobian` runs
setup and proves on the Jacobian MSM engine (`_use_rcb = False` on the
card's device groups).
Prints the card's name and power limit beside every number. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from .bench_circuits import square_chain_shape
from .host.pairing import get_curve
from .ops.msm import device_group
from .schemes import groth16


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _timed(run, reps: int, card: str, what: str, log2: int) -> None:
    walls, stages, peak = [], [], 0
    for _ in range(reps):
        st: dict = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run(st)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated())
        stages.append(st)
    q = statistics.quantiles(walls, n=4) if len(walls) > 1 else [walls[0]] * 3
    print(json.dumps({f"{what}_s": {"n": len(walls), "median": statistics.median(walls),
                                    "q1": q[0], "q3": q[2], "min": min(walls),
                                    "max": max(walls), "all": walls},
                      "peak_device_memory_bytes": peak, "card": card, "log2": log2}))
    med = {k: statistics.median(st[k] for st in stages) for k in stages[0]}
    print(json.dumps({"stage_median_s": med, "card": card}))


def _profiled(run, card: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run({})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:40]
    reads = {n: v for n, v in by_name.items() if "gather" in n or "index" in n}
    print(json.dumps({"profiled_s": wall, "device_busy_s": busy,
                      "device_idle_share": 1 - busy / wall,
                      "kernel_launches": len(kernels),
                      "row_read_launches": sum(n for n, _ in reads.values()),
                      "row_read_ms": sum(ms for _, ms in reads.values()), "card": card}))
    for name, (n, ms) in sorted(reads.items(), key=lambda kv: -kv[1][1]):
        print(f"row read: {ms:10.3f} ms {n:6d} x  {name[:110]}")
    for name, (n, ms) in top:
        print(f"{ms:10.3f} ms {n:6d} x  {name[:110]}")
    for (name, grid, block), (n, ms) in sorted(_by_shape(prof).items()):
        print(f"shape: {ms:10.3f} ms {n:6d} x  {name} grid {grid} block {block}")


# the port's kernels (csrc/): their own names in the trace's demangled ones
_OWN = re.compile(r"\b((?:ec|rcb|mont)_\w+?)(?:<|\()")


def _by_shape(prof) -> dict:
    """(kernel, grid, block) -> (launches, device ms) of the port's own
    kernels in the profile, from its Chrome trace (the trace's kernel
    records carry the launch's grid and block)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out: dict = {}
    for e in events:
        m = _OWN.search(e.get("name", ""))
        if e.get("cat") != "kernel" or not m:
            continue
        a = e.get("args", {})
        key = (m.group(1), str(a.get("grid")), str(a.get("block")))
        n, ms = out.get(key, (0, 0.0))
        out[key] = (n + 1, ms + e.get("dur", 0) / 1e3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2", type=int, default=20)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--setup", action="store_true",
                    help="time and profile the setup instead of the prove")
    ap.add_argument("--engine", choices=("rcb", "jacobian"), default="rcb",
                    help="the MSM engine of setup and prove")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_prove: needs a CUDA card", file=sys.stderr)
        return 2

    card = f"{_card()}, {args.engine} engine"
    curve = get_curve("bn254")
    for g in ("g1", "g2"):
        device_group(curve, g, "cuda")._use_rcb = args.engine == "rcb"
    fr = curve.fr.modulus
    shape = square_chain_shape((1 << args.log2) - 2, fr, seed=7)

    def setup(st):
        return groth16.generate_parameters_from_shape(
            shape, curve, 3, 5, 7, 11, 13, device="cuda", timings=st)

    params = setup({})
    if args.setup:
        _timed(setup, args.reps, card, "setup", args.log2)
        _profiled(setup, card)
        return 0
    r, s = 17, 19

    def prove(st):
        return groth16.create_proof_from_shape(params, shape, r, s, timings=st)

    prove({})
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    _timed(prove, args.reps, card, "prove", args.log2)
    print(json.dumps({"device_memory_held_bytes": {
        "after_warmup": held, "after_timed": torch.cuda.memory_allocated()},
        "card": card}))
    _profiled(prove, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The team kernels at every shape of a 2^log2 prove and the setups'
fixed-base MSMs, one tree's kernels against another's, in one call on the
card: K3 and K4 at each level, K2 at the prove's window batch, K5 at each
of its shapes, K6's fixed-base MSM at the setup's width; on the Jacobian
engine K8 at each shape of its prove, its window folds, and K9a's
fixed-base MSM at the setup's width, and K9b and K9c at the prove's
window batch.

    python3 ckb_zkp_tpu_torch/probes/levels.py --parent DIR [--log2 20] [--reps 20]
        [--out OUT]

DIR is an unpacked checkout of an earlier commit (for example `git archive
HEAD | tar -x -C _archive/parent`, a directory `.gitignore` lists). Each
tree builds its own kernels (in its own `ckb_zkp_tpu_torch/_build/`) and
times them on the same inputs (drawn on the card from one seed), in four
processes: parent, this tree, this tree, parent. The shapes come from this
tree's `chip_smoke.py`: every (kernel, M, B) of `scan_levels(log2)` for
`cuda_rcb.scan_prefix_add` / `scan_total_add`; `cuda_rcb.scan_prefix_madd`
at (batch * npad, 32) over npad packed leaves (1% flagged) through the sort
order of random digits, as the MSM's `_windows` calls it (a tree whose K2
takes no order is timed as the gather of the sorted leaves and K2, as its
MSM ran them); `cuda_rcb.rcb_add` at every shape of `k5_shapes(log2)`; the fixed-base
MSM of 2^log2 scalars (uniform below r's top limb) over random window
tables of 32 x 256 rows, as `cuda_rcb.rcb_fixed_base` where the tree has it
and else as the per-window loop it replaced (an int64 copy of the scalars,
and per window the digits, two table-row gathers and the elementwise K6);
the Jacobian engine's K8 (`cuda_ec.ec_add`) at every shape of
`k8_shapes(log2)`; its window folds at the shapes `k8_shapes` gives the
chain (`_window_sums`' k points with c and 0 doublings, the fold's one
point with 32 rounds of c from infinity), as `cuda_ec.ec_add_chain` where
the tree has it and else as the loop of K8 launches it replaced; and K9a's
fixed-base MSM of 2^log2 scalars, as `cuda_ec.ec_fixed_base` where the
tree has it and else as the per-window loop of elementwise K9a
(`jacobian_window_loop`), its totals normalized before they are hashed (the
two differ before normalization only for a zero scalar); K9b
(`cuda_ec.block_totals_madd`) over (jb * npad, 32) leaves through the sort
order of random 8-bit digits over npad leaves (1% flagged) where the tree
reads the leaves through an order, else as the sorted copy of the leaves
and the tree's K9b over it, as its MSM ran them; K9c (`cuda_ec.block_totals_add`) over
jb * npad / 32 points;
G1 and G2. Each call is timed by CUDA events and by the device time of its
kernels in a `torch.profiler` trace (for a launch of a few points, events
measure mostly the host's launch overhead). Every output of every run must
be the same bits (a SHA-256 of its limbs), so the two trees' kernels agree
shape for shape. A tree whose `cuda_rcb` has `team_shape` also reports each
shape's threads and block size (K2 and K5 only where they run on the
team). Prints the card's name and power limit,
one line a shape, the registers and spills of the team kernels in both
trees' nvcc logs, and one JSON line; with `--out`, writes the runs' JSON
and both trees' nvcc logs there. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
SEED = 20261017
# run by path, the script's own directory would shadow top-level modules
sys.path = [p for p in sys.path if os.path.abspath(p or ".") != HERE]


def device_ms(fn, iters: int) -> float | None:
    """Mean milliseconds of device time a call of fn(): the summed
    durations of the card's kernels in a `torch.profiler` trace of iters
    calls, after a warm-up. Unlike events around a call, it leaves out the
    host's launch overhead, which is most of what events measure for a
    launch of a few points. None if two traces caught no kernel. (Here and
    not in `common`: the worker imports the measured tree's `common`,
    which may predate it.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(2):  # a trace that caught no kernel is taken again, once
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    return None


def window_loop(rg, X, Y, sc):
    """The setup's fixed-base MSM before K6's fixed-base kernel: from an
    int64 copy of the scalars sc (n, 16), a window at a time the 8-bit
    digits d, the table rows X[w][d], Y[w][d] gathered, and the
    elementwise mixed add `rg.madd` (the elementwise K6 on the card) with
    the flag d == 0. Projective totals."""
    import torch

    s64 = sc.to(torch.int64)
    acc = rg.identity((sc.shape[0],))
    for w in range(X.shape[0]):
        d = (s64[:, w // 2] >> (8 * (w % 2))) & 255
        acc = rg.madd(acc, (X[w][d], Y[w][d], d == 0))
    return acc


def jacobian_window_loop(cf, X, Y, sc):
    """The Jacobian setup's fixed-base MSM before K9a's fixed-base kernel
    (the reference's `_fixed_base_impl`): from infinity, a window at a time
    the 8-bit digits d of the scalars sc (n, 16), the table rows X[w][d],
    Y[w][d] gathered, and the elementwise K9a (`cuda_ec.ec_madd`) with the
    flag d == 0. Jacobian totals, before normalization."""
    import torch

    from ckb_zkp_tpu_torch.ops import cuda_ec, ec

    s64 = sc.to(torch.int64)
    acc = ec.point_infinity(cf, (sc.shape[0],))
    for w in range(X.shape[0]):
        d = (s64[:, w // 2] >> (8 * (w % 2))) & 255
        acc = cuda_ec.ec_madd(cf, acc, (X[w][d], Y[w][d], d == 0))
    return acc


def worker(tree: str, shapes: list, reps: int) -> dict:
    """Time each shape with the kernels of `tree` (imported from there)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_build, cuda_ec, cuda_rcb, ec
    from ckb_zkp_tpu_torch.ops.msm import device_group
    from ckb_zkp_tpu_torch.probes.common import cuda_ms, rand_field

    cuda_build.lib()
    team_shape = getattr(cuda_rcb, "team_shape", None)
    ec_lanes = getattr(cuda_ec, "ec_team_lanes", None)
    chain = getattr(cuda_ec, "ec_add_chain", None)
    jac_fixed_base = getattr(cuda_ec, "ec_fixed_base", None)
    fixed_base = getattr(cuda_rcb, "rcb_fixed_base", None)
    fused = "order" in inspect.signature(cuda_rcb.scan_prefix_madd).parameters
    # K9b through an order
    ordered_k9b = "order" in inspect.signature(cuda_ec.block_totals_madd).parameters
    curve = get_curve("bn254")
    out = []
    for gi, group in enumerate(("g1", "g2")):
        dg = device_group(curve, group, "cuda")
        rg, cs = dg.rg, dg.cf.coord_shape
        for si, (name, M, B, nleaves) in enumerate(shapes):
            rng = np.random.default_rng([SEED, gi, si])
            if name == "scan_prefix_madd":
                X, Y = (rand_field(rng, nleaves, cs, dg.fq) for _ in range(2))
                inf = torch.as_tensor(rng.random(nleaves) < 0.01, device="cuda")
                xw, yw = cuda_rcb.pack_limbs_flag(rg, X, Y, inf)
                gen = torch.Generator(device="cuda")
                gen.manual_seed(int(rng.integers(1 << 62)))
                digits = torch.randint(0, 1 << 16, (M // nleaves, nleaves), generator=gen,
                                       device="cuda")
                order = torch.sort(digits, dim=1).indices.reshape(-1)
                del X, Y, inf, digits
                if fused:
                    def fn():
                        return cuda_rcb.scan_prefix_madd(rg, xw, yw, B, order=order)
                else:  # the parent's window: sorted copies, then K2
                    def fn():
                        return cuda_rcb.scan_prefix_madd(rg, xw[order], yw[order], B)
                teams = M // B
            elif name == "ec_block_totals_madd":
                X, Y = (rand_field(rng, nleaves, cs, dg.fq) for _ in range(2))
                inf = torch.as_tensor(rng.random(nleaves) < 0.01, device="cuda")
                lv = (X, Y, inf)
                gen = torch.Generator(device="cuda")
                gen.manual_seed(int(rng.integers(1 << 62)))
                digits = torch.randint(0, 256, (M // nleaves, nleaves), generator=gen,
                                       device="cuda")
                order = torch.sort(digits, dim=1).indices.reshape(-1)
                del X, Y, inf, digits
                if ordered_k9b:
                    def fn():
                        return cuda_ec.block_totals_madd(dg.cf, lv, B, order)
                else:  # the parent's window: sorted copies, then K9b
                    def fn():
                        return cuda_ec.block_totals_madd(dg.cf, tuple(c[order] for c in lv), B)
                teams = M // B
            elif name == "ec_block_totals_add":
                pts = tuple(rand_field(rng, M, cs, dg.fq) for _ in range(3))

                def fn():
                    return cuda_ec.block_totals_add(dg.cf, pts, B)
                teams = M // B
            elif name == "fixed_base":
                X, Y = (rand_field(rng, 32 * 256, cs, dg.fq).reshape(32, 256, *cs)
                        for _ in range(2))
                gen = torch.Generator(device="cuda")
                gen.manual_seed(int(rng.integers(1 << 62)))
                sc = torch.randint(0, 1 << 16, (M, 16), generator=gen, device="cuda",
                                   dtype=torch.int32)
                sc[:, -1] = torch.randint(0, curve.fr.modulus >> 240, (M,), generator=gen,
                                          device="cuda", dtype=torch.int32)
                if fixed_base:
                    def fn():
                        return fixed_base(rg, X, Y, sc)
                else:  # the parent's fixed-base MSM: the per-window loop
                    def fn():
                        return window_loop(rg, X, Y, sc)
                teams = M
            elif name == "jac_fixed_base":
                X, Y = (rand_field(rng, 32 * 256, cs, dg.fq).reshape(32, 256, *cs)
                        for _ in range(2))
                gen = torch.Generator(device="cuda")
                gen.manual_seed(int(rng.integers(1 << 62)))
                sc = torch.randint(0, 1 << 16, (M, 16), generator=gen, device="cuda",
                                   dtype=torch.int32)
                sc[:, -1] = torch.randint(0, curve.fr.modulus >> 240, (M,), generator=gen,
                                          device="cuda", dtype=torch.int32)
                if jac_fixed_base:
                    def fn():
                        return jac_fixed_base(dg.cf, X, Y, sc)
                else:  # the parent's fixed-base MSM: the per-window loop
                    def fn():
                        return jacobian_window_loop(dg.cf, X, Y, sc)
                teams = M
            elif name == "ec_add_chain":
                k, rounds = M, B
                dbl = [8] * rounds if k == 1 else [8] + [0] * (rounds - 1)
                init = (ec.point_infinity(dg.cf, (k,)) if k == 1
                        else tuple(rand_field(rng, k, cs, dg.fq) for _ in range(3)))
                add = tuple(rand_field(rng, rounds * k, cs, dg.fq).reshape(rounds, k, *cs)
                            for _ in range(3))
                if chain:
                    def fn():
                        return chain(dg.cf, init, add, dbl)
                else:  # the parent's fold: a loop of K8 launches
                    def fn():
                        acc = init
                        for r, d in enumerate(dbl):
                            for _ in range(d):
                                acc = cuda_ec.ec_add(dg.cf, acc, acc)
                            acc = cuda_ec.ec_add(dg.cf, acc, tuple(a[r] for a in add))
                        return acc
                teams = k
            elif name in ("rcb_add", "ec_add"):
                P = tuple(rand_field(rng, M, cs, dg.fq) for _ in range(3))
                Q = tuple(rand_field(rng, M, cs, dg.fq) for _ in range(3))
                if name == "rcb_add":
                    def fn():
                        return cuda_rcb.rcb_add(rg, P, Q)
                else:
                    def fn():
                        return cuda_ec.ec_add(dg.cf, P, Q)
                teams = M
            else:
                pts = tuple(rand_field(rng, M, cs, dg.fq) for _ in range(3))
                kern = getattr(cuda_rcb, name)

                def fn():
                    return kern(rg, pts, B)
                teams = M // B

            res = fn()
            flat = res[0] + res[1] if name in ("scan_prefix_add", "scan_prefix_madd") else res
            if name == "jac_fixed_base":
                flat = dg._normalize(res)
            torch.cuda.synchronize()
            h = hashlib.sha256()
            for t in flat:
                h.update(t.cpu().numpy().tobytes())
            del res, flat
            n = reps if M < 1 << 20 else max(3, reps // 4)
            row = {"name": name, "group": group, "M": M, "B": B, "sha256": h.hexdigest()[:16],
                   "ms": cuda_ms(fn, n), "device_ms": device_ms(fn, n)}
            if name in ("ec_add", "ec_add_chain") or (
                    ordered_k9b and name.startswith("ec_block_totals")):
                if name == "ec_block_totals_madd":
                    row["threads"] = teams
                elif ec_lanes:
                    row["threads"] = teams * ec_lanes(dg.cf, teams)
            elif team_shape and "fixed_base" not in name and not name.startswith("ec_") and (
                    fused or name not in ("scan_prefix_madd", "rcb_add")):
                lanes, row["block"] = team_shape(rg, teams)
                row["threads"] = teams * lanes
            out.append(row)
            fn = None
            torch.cuda.empty_cache()
    return {"tree": tree, "build_s": cuda_build.BUILD_INFO.get("seconds"), "fused_k2": fused,
            "fixed_base_kernel": fixed_base is not None, "k8_chain": chain is not None,
            "k9a_fixed_base_kernel": jac_fixed_base is not None,
            "k9b_through_order": ordered_k9b, "shapes": out}


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
# a kernel's own name in its mangled name: its length, the name, its
# template arguments (the anonymous namespace's part names the file)
_KERNEL = re.compile(r"\d+(rcb_team_scan|rcb_team_madd_scan|rcb_team_add|rcb_scan_kernel|"
                     r"rcb_add_kernel|rcb_team_fixed_base|rcb_fixed_base_kernel|"
                     r"rcb_madd_kernel|ec_team_add|ec_team_chain|"
                     r"ec_add_kernel|ec_fixed_base_kernel|ec_madd_kernel|ec_scan_kernel)"
                     r"I(\w+?)EEv")


def registers(log: str) -> list:
    """(kernel instance, registers, spill stores, spill loads) of the RCB
    and Jacobian point kernels in an nvcc --resource-usage log."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            name, spill = m.group(1), (0, 0)
        elif m := _SPILL.search(line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := _REGS.search(line)) and name:
            if k := _KERNEL.search(name):  # with its template arguments <NW,EXT,...>
                targs = ",".join(re.findall(r"L[ib](\d+)E", k.group(2) + "E"))
                rows.append((f"{k.group(1)}<{targs}>", int(m.group(1)), *spill))
            name = None
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier checkout to compare with")
    ap.add_argument("--log2", type=int, default=20)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="a directory for the runs' JSON and nvcc logs")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--shapes", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("SHAPES " + json.dumps(worker(args.worker, json.loads(args.shapes), args.reps)))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("levels: torch.cuda.is_available() is False; this runs only on a CUDA card",
              file=sys.stderr)
        return 2
    if not args.parent or not os.path.isdir(os.path.join(args.parent, "ckb_zkp_tpu_torch")):
        print("levels: --parent must name an unpacked checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from ckb_zkp_tpu_torch.probes.common import smi

    card = smi()
    sizes = chip_smoke.path_shapes(args.log2, 256)
    shapes = [(name, M, B, None) for name, M, B in chip_smoke.scan_levels(args.log2)]
    shapes.append(("scan_prefix_madd", sizes["scan_prefix_madd"], 32, 1 << args.log2))
    shapes += [("rcb_add", n, None, None) for n, _ in chip_smoke.k5_shapes(args.log2)]
    shapes.append(("fixed_base", sizes["rcb_fixed_base"], 32, None))
    adds, chains = chip_smoke.k8_shapes(args.log2)
    shapes += [("ec_add", n, None, None) for n, _ in adds]
    shapes += [("ec_add_chain", k, 32 if k == 1 else 2, None) for k, _ in chains]
    shapes.append(("jac_fixed_base", sizes["ec_fixed_base"], 32, None))
    shapes.append(("ec_block_totals_madd", sizes["ec_block_totals_madd"], 32, 1 << args.log2))
    shapes.append(("ec_block_totals_add", sizes["ec_block_totals_add"], 32, None))
    parent = os.path.abspath(args.parent)
    runs = []
    for tree in (parent, REPO, REPO, parent):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--shapes", json.dumps(shapes), "--reps", str(args.reps)],
            capture_output=True, text=True, cwd=tree)
        line = [x for x in proc.stdout.splitlines() if x.startswith("SHAPES ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-3000:] + proc.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append(json.loads(line[0][len("SHAPES "):]))
        print(f"{tree}: built in {runs[-1]['build_s']} s, K2 fused with the order: "
              f"{runs[-1]['fused_k2']}, fixed-base kernel: "
              f"{runs[-1]['fixed_base_kernel']}, K8 chain: {runs[-1]['k8_chain']}, K9a "
              f"fixed-base kernel: {runs[-1]['k9a_fixed_base_kernel']}, K9b through the "
              f"order: {runs[-1].get('k9b_through_order')}", flush=True)
    summary = []
    for i in range(len(runs[0]["shapes"])):
        rows = [r["shapes"][i] for r in runs]
        if len({r["sha256"] for r in rows}) != 1:
            raise AssertionError(f"the trees' kernels disagree at {rows[0]}")
        old, new = (rows[0], rows[3]), (rows[1], rows[2])

        def shape_of(r):
            if "threads" not in r:
                return ""
            return f" ({r['threads']} threads" + (
                f", blocks of {r['block']})" if "block" in r else ")")

        def pair(a, b, key):
            return " / ".join("not measured" if r[key] is None else f"{r[key]:.6f}"
                              for r in (a, b))

        r0 = rows[0]
        print(f"{r0['group']} {r0['name']} M={r0['M']} B={r0['B']}: "
              f"parent {pair(*old, 'ms')} ms, device {pair(*old, 'device_ms')}"
              f"{shape_of(old[0])}; change {pair(*new, 'ms')} ms, device "
              f"{pair(*new, 'device_ms')}{shape_of(new[0])}; outputs equal [{card}]")
        summary.append({k: r0[k] for k in ("name", "group", "M", "B")}
                       | {"parent_ms": [old[0]["ms"], old[1]["ms"]],
                          "change_ms": [new[0]["ms"], new[1]["ms"]],
                          "parent_device_ms": [old[0]["device_ms"], old[1]["device_ms"]],
                          "change_device_ms": [new[0]["device_ms"], new[1]["device_ms"]]}
                       | {k: new[0][k] for k in ("threads", "block") if k in new[0]})
    regs = {}
    for tag, tree in (("parent", parent), ("change", REPO)):
        log = os.path.join(tree, "ckb_zkp_tpu_torch", "_build", "build.log")
        text = open(log).read() if os.path.exists(log) else ""
        regs[tag] = registers(text)
        for name, n, st, ld in regs[tag]:
            print(f"registers {tag}: {name} {n}, spill stores {st} B, loads {ld} B")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"levels_build_{tag}.log"), "w") as f:
                f.write(text)
    if args.out:
        with open(os.path.join(args.out, "levels.json"), "w") as f:
            json.dump({"card": card, "log2": args.log2, "runs": runs, "registers": regs}, f,
                      indent=1)
    print(card)
    print(json.dumps({"shapes": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

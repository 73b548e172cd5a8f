"""K3 and K4 at every level of a 2^log2 prove, one tree's kernels against
another's, in one call on the card.

    python3 ckb_zkp_tpu_torch/probes/levels.py --parent DIR [--log2 20] [--reps 20]
        [--out OUT]

DIR is an unpacked checkout of an earlier commit (for example `git archive
HEAD | tar -x -C _archive/parent`, a directory `.gitignore` lists). For
every (kernel, M, B) of `chip_smoke.scan_levels(log2)`, G1 and G2, each
tree builds its own kernels (in its own `ckb_zkp_tpu_torch/_build/`) and
times `cuda_rcb.scan_prefix_add` / `scan_total_add` on the same points
(drawn on the card from one seed) by CUDA events, in four processes:
parent, this tree, this tree, parent. Every output of every run must be
the same bits (a SHA-256 of its limbs), so the two trees' kernels agree
level for level. A tree whose `cuda_rcb` has `team_shape` also reports
each level's threads and block size. Prints the card's name and power
limit, one line a level and one JSON line; with
`--out`, writes the runs' JSON and both trees' nvcc logs (registers,
spills) there. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
SEED = 20261017
# run by path, the script's own directory would shadow top-level modules
sys.path = [p for p in sys.path if os.path.abspath(p or ".") != HERE]


def worker(tree: str, levels: list, reps: int) -> dict:
    """Time each level with the kernels of `tree` (imported from there)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from ckb_zkp_tpu_torch.host.pairing import get_curve
    from ckb_zkp_tpu_torch.ops import cuda_build, cuda_rcb
    from ckb_zkp_tpu_torch.ops.msm import device_group
    from ckb_zkp_tpu_torch.probes.common import cuda_ms, rand_field

    cuda_build.lib()
    shape = getattr(cuda_rcb, "team_shape", None)
    curve = get_curve("bn254")
    out = []
    for gi, group in enumerate(("g1", "g2")):
        dg = device_group(curve, group, "cuda")
        rg, cs = dg.rg, dg.cf.coord_shape
        for li, (name, M, B) in enumerate(levels):
            rng = np.random.default_rng([SEED, gi, li])
            pts = tuple(rand_field(rng, M, cs, dg.fq) for _ in range(3))
            kern = getattr(cuda_rcb, name)

            def digest():
                res = kern(rg, pts, B)
                flat = res[0] + res[1] if name == "scan_prefix_add" else res
                torch.cuda.synchronize()
                h = hashlib.sha256()
                for t in flat:
                    h.update(t.cpu().numpy().tobytes())
                return h.hexdigest()[:16]

            chains = M // B
            row = {"name": name, "group": group, "M": M, "B": B, "chains": chains,
                   "sha256": digest(), "ms": cuda_ms(lambda: kern(rg, pts, B), reps)}
            if shape:
                lanes, row["block"] = shape(rg, chains)
                row["threads"] = chains * lanes
            out.append(row)
            del pts
        torch.cuda.empty_cache()
    return {"tree": tree, "build_s": cuda_build.BUILD_INFO.get("seconds"), "levels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked earlier checkout to compare with")
    ap.add_argument("--log2", type=int, default=20)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="a directory for the runs' JSON and nvcc logs")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--levels", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("LEVELS " + json.dumps(worker(args.worker, json.loads(args.levels), args.reps)))
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
    levels = chip_smoke.scan_levels(args.log2)
    parent = os.path.abspath(args.parent)
    runs = []
    for tree in (parent, REPO, REPO, parent):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--levels", json.dumps(levels), "--reps", str(args.reps)],
            capture_output=True, text=True, cwd=tree)
        line = [x for x in proc.stdout.splitlines() if x.startswith("LEVELS ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-3000:] + proc.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append(json.loads(line[0][len("LEVELS "):]))
        print(f"{tree}: built in {runs[-1]['build_s']} s", flush=True)
    for i in range(len(runs[0]["levels"])):
        rows = [r["levels"][i] for r in runs]
        if len({r["sha256"] for r in rows}) != 1:
            raise AssertionError(f"the trees' kernels disagree at {rows[0]}")
        old, new = (rows[0], rows[3]), (rows[1], rows[2])

        def shape_of(r):
            return f" ({r['threads']} threads, blocks of {r['block']})" if "block" in r else ""

        print(f"{rows[0]['group']} {rows[0]['name']} M={rows[0]['M']} B={rows[0]['B']}: "
              f"parent {old[0]['ms']:.6f} / {old[1]['ms']:.6f} ms{shape_of(old[0])}, "
              f"change {new[0]['ms']:.6f} / {new[1]['ms']:.6f} ms{shape_of(new[0])}, "
              f"outputs equal [{card}]")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for tag, tree in (("parent", parent), ("change", REPO)):
            log = os.path.join(tree, "ckb_zkp_tpu_torch", "_build", "build.log")
            if os.path.exists(log):
                with open(log) as f, open(os.path.join(args.out, f"levels_build_{tag}.log"),
                                          "w") as g:
                    g.write(f.read())
        with open(os.path.join(args.out, "levels.json"), "w") as f:
            json.dump({"card": card, "log2": args.log2, "runs": runs}, f, indent=1)
    print(card)
    print(json.dumps({"levels": [
        {k: runs[0]["levels"][i][k] for k in ("name", "group", "M", "B")}
        | {"parent_ms": [runs[0]["levels"][i]["ms"], runs[3]["levels"][i]["ms"]],
           "change_ms": [runs[1]["levels"][i]["ms"], runs[2]["levels"][i]["ms"]]}
        for i in range(len(runs[0]["levels"]))]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

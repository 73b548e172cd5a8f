"""Grid-carried scan probe: P-tot's and P-prepk's functions with each
step's leaves staged through shared memory and the accumulator kept there,
and W written with no arithmetic, on the card.

    python3 -m ckb_zkp_tpu_torch.probes.grid [--log2 21] [--iters 10]

The port of the JAX package's `scripts/probe_scan3.py` and
`probe_scan4.py`: BN254 G1, N = 2^log2 packed affine leaves below p with
no flag set, B = 32 (`scan.make_inputs`). For each variant it prints ms by
CUDA events on one stream and the share of its bound (`common.bound`):

- P7 (`cuda_probe.grid_totals`) beside P-tot (`madd_totals`, K = 1) and
  P8 (`grid_prefix`) beside P-prepk (`madd_prefix_packed`, K = 1), at 64
  and 256 threads per block: staging through shared memory against loads
  straight into registers;
- P11 (`grid_prefix_tile`) at 32 and 64 columns per tile: W held in
  shared memory and written once per tile;
- P9 (`wo_steps`, 64 threads) and P10 (`wo_tile`, 32 and 64 columns): W
  = (x, y, x ^ y) with no arithmetic, written per step or once per tile,
  beside the library yardstick, two `copy_` and one `torch.bitwise_xor`
  timed together.

Before timing, every kernel is held against its plain version on small
inputs and P7, P8 and P11 against P-tot's and P-prepk's kernels. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..host.pairing import get_curve
from ..ops import cuda_probe
from ..ops.limbs import pack_limbs
from ..ops.msm import _RCB_B, device_group
from . import scan
from .common import FQ_BYTES, bound, cuda_ms, max_abs_err, rand_field, require_card, smi

SEED = 20261018


def work(kind: str, n: int, live: int) -> tuple:
    """(bytes, IMADs, tensor-core ops) of one run over n leaves: "tot" and
    "prepk" as the scan probe's, "wo" two reads and three writes of 32 B
    a leaf."""
    if kind == "wo":
        return 5 * n * FQ_BYTES // 2, 0, 0
    return scan.work(kind, n, live)


def library_wo(xw, yw):
    """The yardstick of P9/P10: W = (x, y, x ^ y) by two `copy_` and one
    `torch.bitwise_xor(out=)` into tensors made once."""
    out = tuple(torch.empty_like(xw) for _ in range(3))

    def run():
        out[0].copy_(xw)
        out[1].copy_(yw)
        torch.bitwise_xor(xw, yw, out=out[2])
        return out

    return run


def variants(rg, xw, yw, inf, B: int = _RCB_B):
    """(label, kind, fn) of every timed variant."""
    out = []
    for t in cuda_probe.GRID_THREADS:
        out += [
            (f"P-tot threads={t}", "tot",
             lambda t=t: cuda_probe.madd_totals(rg, xw, yw, inf, B, 1, t)),
            (f"P7 grid totals threads={t}", "tot",
             lambda t=t: cuda_probe.grid_totals(rg, xw, yw, inf, B, t)),
            (f"P-prepk threads={t}", "prepk",
             lambda t=t: cuda_probe.madd_prefix_packed(rg, xw, yw, inf, B, 1, t)),
            (f"P8 grid prefix threads={t}", "prepk",
             lambda t=t: cuda_probe.grid_prefix(rg, xw, yw, inf, B, t))]
    for c in cuda_probe.TILE_COLS:
        out.append((f"P11 grid prefix, W tile cols={c}", "prepk",
                    lambda c=c: cuda_probe.grid_prefix_tile(rg, xw, yw, inf, B, c)))
    out.append(("P9 write-only per step threads=64", "wo",
                lambda: cuda_probe.wo_steps(xw, yw, B)))
    for c in cuda_probe.TILE_COLS:
        out.append((f"P10 write-only, W tile cols={c}", "wo",
                    lambda c=c: cuda_probe.wo_tile(xw, yw, B, c)))
    out.append(("library: 2 copy_ + torch.bitwise_xor", "wo", library_wo(xw, yw)))
    return out


def check(device="cuda") -> None:
    """P7-P11 at every option against their plain versions, and P7, P8,
    P11 against P-tot's and P-prepk's kernels (K = 1, 64 threads), at edge
    shapes: G = 67 columns of B = 32 (a ragged last tile and a partial last
    block at every option) with 1/10 of the leaves flagged and the first
    block all flagged, B = 5 (G = 64), one block of B = n = 7."""
    dg = device_group(get_curve("bn254"), "g1", device)
    rg, df = dg.rg, dg.fq
    for n, B in ((67 * 32, 32), (5 * 64, 5), (7, 7)):
        rng = np.random.default_rng(SEED + n)
        xw, yw = (pack_limbs(rand_field(rng, n, (df.L,), df, device)) for _ in range(2))
        inf = torch.as_tensor(rng.random(n) < 0.1, device=device)
        inf[:B] = n > B  # an all-flagged block where there are several
        want_t = cuda_probe.madd_totals_plain(rg, xw, yw, inf, B)
        want_w, want_tw = cuda_probe.madd_prefix_packed_plain(rg, xw, yw, inf, B)
        k_t = cuda_probe.madd_totals(rg, xw, yw, inf, B, 1, 64)
        k_w, k_tw = cuda_probe.madd_prefix_packed(rg, xw, yw, inf, B, 1, 64)
        want_wo = cuda_probe.wo_plain(xw, yw)
        errs = {}
        for t in cuda_probe.GRID_THREADS:
            T = cuda_probe.grid_totals(rg, xw, yw, inf, B, t)
            errs[f"probe_grid_totals t={t}"] = max(max_abs_err(T, want_t),
                                                   max_abs_err(T, k_t))
            W, T = cuda_probe.grid_prefix(rg, xw, yw, inf, B, t)
            errs[f"probe_grid_prefix t={t}"] = max(max_abs_err(W + T, want_w + want_tw),
                                                   max_abs_err(W + T, k_w + k_tw))
        for c in cuda_probe.TILE_COLS:
            W, T = cuda_probe.grid_prefix_tile(rg, xw, yw, inf, B, c)
            errs[f"probe_grid_prefix_tile cols={c}"] = max(
                max_abs_err(W + T, want_w + want_tw), max_abs_err(W + T, k_w + k_tw))
            errs[f"probe_wo_tile cols={c}"] = max_abs_err(
                cuda_probe.wo_tile(xw, yw, B, c), want_wo)
        errs["probe_wo_steps"] = max_abs_err(cuda_probe.wo_steps(xw, yw, B), want_wo)
        bad = [name for name, e in errs.items() if e]
        if bad:
            raise AssertionError(f"grid probe kernels != plain versions (n={n}, B={B}): {bad}")


def measure(log2: int = 21, iters: int = 10, device="cuda") -> dict:
    """Time every variant at 2^log2 G1 leaves; ms, bound and its share."""
    card = smi()
    dg = device_group(get_curve("bn254"), "g1", device)
    xw, yw, inf, _ = scan.make_inputs(dg, log2, scan.SEED, device)
    n = xw.shape[0]
    live = n - int(inf.sum())
    print(f"grid probe: N = 2^{log2}, B = {_RCB_B}, G1 [{card}]", flush=True)
    rows = []
    for label, kind, fn in variants(dg.rg, xw, yw, inf):
        ms = cuda_ms(fn, iters)
        b = bound(*work(kind, n, live))
        rows.append({"variant": label, "ms": ms, **b, "share": b["bound_ms"] / ms})
        print(f"  {label}: {ms:.6f} ms, bound {b['bound_ms']:.6f} ms ({b['bound_by']}), "
              f"share {b['bound_ms'] / ms:.4f}", flush=True)
    out = {"log2": log2, "B": _RCB_B, "card": card, "variants": rows}
    print(json.dumps({"grid_probe": out}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2", type=int, default=21, help="log2 of the leaves (21)")
    ap.add_argument("--iters", type=int, default=10, help="timed runs of each variant")
    args = ap.parse_args(argv)
    if not require_card("grid probe"):
        return 2
    check()
    measure(args.log2, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())

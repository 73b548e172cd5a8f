"""DMA-pattern probe: o = a ^ b over the same bytes under three blockings.

    python3 -m ckb_zkp_tpu_torch.probes.dma [--log2 21] [--iters 20]

The port of the JAX package's `scripts/probe_dma.py`: 2^log2 elements of
Rp = 8 int32 words, laid out (Rp, M, 128) with M = 2^log2 / 128 rows (at
least 256), or
(B, Rp, M/B, 128) with B = 32; two random arrays in, one out (3 x 64 MiB
at 2^21). Variants: P20 (`cuda_probe.xor_flat`, 1-D grid, sb 32 and 8),
P22 (`xor_grid2d`, 2-D grid, sb 8, B 32), P21 (`xor_lead1`, the scans'
blocks, sb 8, B 32) and the library yardstick, one
`torch.bitwise_xor(a, b, out=o)`; ms by CUDA events on one stream and the
share of the bytes' bound. Before timing every kernel is held against its
plain version at small shapes. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import cuda_probe
from .common import bound, cuda_ms, max_abs_err, require_card, smi

SEED = 20261019
RP, LANES, B = 8, 128, 32


def rand_words(rng, shape, device="cuda"):
    """Random int32 words of `shape`, drawn on `device` by a generator
    seeded from the numpy generator `rng`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 62)))
    return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen, device=device,
                         dtype=torch.int32)


def make_inputs(M: int, seed: int = SEED, device="cuda", planes: int = RP,
                lead: int = B):
    """(a3, b3) of shape (planes, M, 128) and (a4, b4) of shape (lead,
    planes, M/lead, 128)."""
    rng = np.random.default_rng(seed)
    flat = tuple(rand_words(rng, (planes, M, LANES), device) for _ in range(2))
    four = tuple(rand_words(rng, (lead, planes, M // lead, LANES), device) for _ in range(2))
    return flat, four


def rows(n: int) -> int:
    """M for n elements: n / 128, at least one row of P22's 2-D grid (B
    tiles of sb = 8 rows)."""
    return max(n // LANES, 8 * B)


def work(a) -> tuple:
    """(bytes, IMADs, tensor-core ops): two reads and one write of a's words."""
    return 3 * a.numel() * 4, 0, 0


def library_xor(a, b):
    """The yardstick: one `torch.bitwise_xor(a, b, out=o)` into a tensor
    made once."""
    o = torch.empty_like(a)
    return lambda: torch.bitwise_xor(a, b, out=o)


def variants(flat, four):
    """(label, fn, operand) of every timed variant."""
    (a3, b3), (a4, b4) = flat, four
    lead = a4.shape[0]
    return [
        ("P20 flat sb=32 (1-D grid)", lambda: cuda_probe.xor_flat(a3, b3, 32), a3),
        ("P20 flat sb=8 (1-D grid)", lambda: cuda_probe.xor_flat(a3, b3, 8), a3),
        (f"P22 flat sb=8, 2-D grid B={lead}",
         lambda: cuda_probe.xor_grid2d(a3, b3, 8, lead), a3),
        (f"P21 lead1 sb=8 B={lead}", lambda: cuda_probe.xor_lead1(a4, b4, 8), a4),
        ("library: torch.bitwise_xor (flat)", library_xor(a3, b3), a3)]


def check(device="cuda") -> None:
    """P20 (sb 8, 32), P21 and P22 against their plain versions at small
    shapes: 8 planes of 256 rows with B = 32 (one tile per j for P21), and
    3 planes of 96 rows with B = 4."""
    for planes, m, lead in ((RP, 256, B), (3, 96, 4)):
        flat, four = make_inputs(m, SEED + m, device, planes, lead)
        (a3, b3), (a4, b4) = flat, four
        want3, want4 = cuda_probe.xor_plain(a3, b3), cuda_probe.xor_plain(a4, b4)
        errs = {f"probe_xor_flat sb={sb}": max_abs_err(cuda_probe.xor_flat(a3, b3, sb), want3)
                for sb in cuda_probe.XOR_SB["flat"]}
        errs["probe_xor_grid2d"] = max_abs_err(cuda_probe.xor_grid2d(a3, b3, 8, lead), want3)
        errs["probe_xor_lead1"] = max_abs_err(cuda_probe.xor_lead1(a4, b4, 8), want4)
        bad = [name for name, e in errs.items() if e]
        if bad:
            raise AssertionError(f"dma probe kernels != plain versions ({planes} planes of "
                                 f"{m} rows, B={lead}): {bad}")


def measure(log2: int = 21, iters: int = 20, device="cuda") -> dict:
    """Time every variant at 2^log2 elements; ms, bound and its share."""
    card = smi()
    flat, four = make_inputs(rows(1 << log2), SEED, device)
    M = flat[0].shape[1]
    print(f"dma probe: {M * LANES} elements of {RP} words, B = {B} [{card}]", flush=True)
    out = []
    for label, fn, a in variants(flat, four):
        ms = cuda_ms(fn, iters)
        b = bound(*work(a))
        out.append({"variant": label, "ms": ms, **b, "share": b["bound_ms"] / ms})
        print(f"  {label}: {ms:.6f} ms, bound {b['bound_ms']:.6f} ms ({b['bound_by']}), "
              f"share {b['bound_ms'] / ms:.4f}", flush=True)
    res = {"elements": M * LANES, "Rp": RP, "B": B, "card": card, "variants": out}
    print(json.dumps({"dma_probe": res}), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2", type=int, default=21, help="log2 of the elements (21)")
    ap.add_argument("--iters", type=int, default=20, help="timed runs of each variant")
    args = ap.parse_args(argv)
    if not require_card("dma probe"):
        return 2
    check()
    measure(args.log2, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())

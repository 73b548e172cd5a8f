"""Scan probe: K2b's function and a Montgomery product chain under other
organisations on the card.

    python3 -m ckb_zkp_tpu_torch.probes.scan [--log2 21] [--iters 10]

The port of the JAX package's `scripts/probe_scan.py`, `probe_scan2.py`
and `probe_scan7.py` (its VPU totals, `:124`): BN254 G1, N = 2^log2 packed
affine leaves below p with no flag set (as there), B = 32. For each
variant it prints ms by CUDA events on one stream and the share of its
bound (`common.bound`) the kernel reaches:

- P-tot (`cuda_probe.madd_totals`, block totals only) for K = 1, 2, 4
  block-columns per thread, at 32, 64, 128 and 256 threads per block;
- P-pre: K2b itself (`cuda_rcb.scan_prefix_madd_packed`, 64 threads);
- P-prepk (`cuda_probe.madd_prefix_packed`, W written packed) for K = 1, 4
  at each block size;
- P-chain (`cuda_probe.chain_mul`, B Montgomery products per column of
  limb rows) for K = 1, 2, 4 at each block size.

Before timing, every kernel is held against its plain version on a small
input (every K and block size, flagged leaves, a partial last thread).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..host.pairing import get_curve
from ..ops import cuda_probe, cuda_rcb
from ..ops.limbs import pack_limbs
from ..ops.msm import _RCB_B, device_group
from .common import (FQ_BYTES, IMAD_PER_FQ_MUL, bound, cuda_ms, fq_muls, max_abs_err,
                     rand_field, require_card, smi)

SEED = 20261017


def make_inputs(dg, log2: int, seed: int = SEED, device="cuda"):
    """(xw, yw, inf, x): packed G1 leaves (N, 8) below p, no flag set, and
    (N, 16) limb rows below p for the chain."""
    rng = np.random.default_rng(seed)
    n = 1 << log2
    xw, yw = (pack_limbs(rand_field(rng, n, (dg.fq.L,), dg.fq, device)) for _ in range(2))
    inf = torch.zeros(n, dtype=torch.bool, device=device)
    return xw, yw, inf, rand_field(rng, n, (dg.fq.L,), dg.fq, device)


def work(kind: str, n: int, live: int, B: int = _RCB_B) -> tuple:
    """(bytes, IMADs) of one run over n G1 leaves, live of them unflagged:
    packed leaves in (64 B a leaf, 1 B a flag), W out (packed for P-prepk,
    limb rows for P-pre), T out; P-chain reads limb rows and writes T."""
    G = n // B
    if kind == "chain":
        return (n + G) * FQ_BYTES, n * IMAD_PER_FQ_MUL
    w_out = {"tot": 0, "prepk": 3 * n * FQ_BYTES // 2, "pre": 3 * n * FQ_BYTES}[kind]
    return (n * FQ_BYTES + n + w_out + 3 * G * FQ_BYTES,
            live * fq_muls("madd", 1) * IMAD_PER_FQ_MUL)


def variants(dg, xw, yw, inf, x, B: int = _RCB_B):
    """(label, kind, fn) of every timed variant."""
    rg, df = dg.rg, dg.fq
    out = []
    for t in cuda_probe.THREADS:
        for k in cuda_probe.CHAINS:
            out.append((f"P-tot K={k} threads={t}", "tot",
                        lambda k=k, t=t: cuda_probe.madd_totals(rg, xw, yw, inf, B, k, t)))
    out.append(("P-pre (K2b) threads=64", "pre",
                lambda: cuda_rcb.scan_prefix_madd_packed(rg, xw, yw, inf, B)))
    for t in cuda_probe.THREADS:
        for k in (1, 4):
            out.append((f"P-prepk K={k} threads={t}", "prepk",
                        lambda k=k, t=t: cuda_probe.madd_prefix_packed(
                            rg, xw, yw, inf, B, k, t)))
    for t in cuda_probe.THREADS:
        for k in cuda_probe.CHAINS:
            out.append((f"P-chain K={k} threads={t}", "chain",
                        lambda k=k, t=t: cuda_probe.chain_mul(df, x, B, k, t)))
    return out


def check(device="cuda") -> None:
    """Every probe kernel, at every K and block size, and K2b against their
    plain versions at edge shapes: G = 67 columns of B = 32 (a partial
    last thread for K = 2, 4) with 1/10 of the leaves flagged and the first
    block all flagged, B = 5 tail blocks, one block of B = n = 7."""
    dg = device_group(get_curve("bn254"), "g1", device)
    rg, df = dg.rg, dg.fq
    for n, B in ((67 * 32, 32), (5 * 64, 5), (7, 7)):
        rng = np.random.default_rng(SEED + n)
        xw, yw = (pack_limbs(rand_field(rng, n, (df.L,), df, device)) for _ in range(2))
        inf = torch.as_tensor(rng.random(n) < 0.1, device=device)
        inf[:B] = n > B  # an all-flagged block where there are several
        x = rand_field(rng, n, (df.L,), df, device)
        want_t = cuda_probe.madd_totals_plain(rg, xw, yw, inf, B)
        want_w, want_tw = cuda_probe.madd_prefix_packed_plain(rg, xw, yw, inf, B)
        want_c = cuda_probe.chain_mul_plain(df, x, B)
        got = cuda_rcb.scan_prefix_madd_packed(rg, xw, yw, inf, B)
        want = cuda_rcb.scan_prefix_madd_packed_plain(rg, xw, yw, inf, B)
        errs = {"scan_prefix_madd_packed": max_abs_err(got[0] + got[1], want[0] + want[1])}
        for t in cuda_probe.THREADS:
            for k in cuda_probe.CHAINS:
                W, T = cuda_probe.madd_prefix_packed(rg, xw, yw, inf, B, k, t)
                errs[f"probe_madd_totals k={k} t={t}"] = max_abs_err(
                    cuda_probe.madd_totals(rg, xw, yw, inf, B, k, t), want_t)
                errs[f"probe_madd_prefix_packed k={k} t={t}"] = max_abs_err(
                    W + T, want_w + want_tw)
                errs[f"probe_chain_mul k={k} t={t}"] = max_abs_err(
                    cuda_probe.chain_mul(df, x, B, k, t), want_c)
        bad = [name for name, e in errs.items() if e]
        if bad:
            raise AssertionError(f"scan probe kernels != plain versions (n={n}, B={B}): {bad}")


def measure(log2: int = 21, iters: int = 10, device="cuda") -> dict:
    """Time every variant at 2^log2 G1 leaves; ms, bound and its share."""
    card = smi()
    dg = device_group(get_curve("bn254"), "g1", device)
    xw, yw, inf, x = make_inputs(dg, log2, SEED, device)
    n = xw.shape[0]
    live = n - int(inf.sum())
    print(f"scan probe: N = 2^{log2}, B = {_RCB_B}, G1 [{card}]", flush=True)
    rows = []
    for label, kind, fn in variants(dg, xw, yw, inf, x):
        ms = cuda_ms(fn, iters)
        b = bound(*work(kind, n, live))
        rows.append({"variant": label, "ms": ms, **b, "share": b["bound_ms"] / ms})
        print(f"  {label}: {ms:.6f} ms, bound {b['bound_ms']:.6f} ms ({b['bound_by']}), "
              f"share {b['bound_ms'] / ms:.4f}", flush=True)
    out = {"log2": log2, "B": _RCB_B, "card": card, "variants": rows}
    print(json.dumps({"scan_probe": out}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2", type=int, default=21, help="log2 of the leaves (21)")
    ap.add_argument("--iters", type=int, default=10, help="timed runs of each variant")
    args = ap.parse_args(argv)
    if not require_card("scan probe"):
        return 2
    check()
    measure(args.log2, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Tensor-core probe: the int8 tensor cores against the integer multipliers
for the Montgomery reduction, on the card.

    python3 -m ckb_zkp_tpu_torch.probes.mxu [--iters 10]

The port of the JAX package's `scripts/probe_mxu.py` and
`scripts/probe_mxu2.py`. It prints, each in ms by CUDA events on one stream
beside its bound (`common.bound`):

- P14 (`cuda_probe.u32_ops`): 512 chained wrapping u32 steps on each of
  256 tiles of 8 x 128 elements, for each op (add, mul, mulmask, shift),
  with the steps per second; its bound counts one op a step (the fewest a
  step can take) at 64 per SM per clock, the rate of 32-bit add,
  multiply-add, shift and logical ops on compute capability 9.0 (CUDA C++
  Programming Guide, arithmetic instruction throughput);
- P15 (`cuda_probe.band_mma`): n_mm = 8 and 32 chained int8 band-matrix
  products per tile of 256 rows x 128 columns, 256 tiles, with the time
  per (256, 256) x (256, 128) product;
- P16 (CIOS) against P17 (tensor-core reduction, `csrc/mont_tc.cuh`):
  `cuda_probe.mul_chain` on 2^20 BN254 Fq elements, flat (one product) and
  chain4 (four chained), with G mul/s; P17 must equal P16 limb for limb.

Field inputs are canonical (`rand_field`), so the two reductions agree on
the timed inputs too (the reference timed raw 16-bit limbs up to 2^256).
Before timing, every kernel is held against its plain version on small
inputs: every op, n_mm 1, 8 and 32 on 2 tiles, and the multiply chains at
67 and 1 elements (a partial warp) with the edge values 0, 1, p - 1 and
R mod p. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..host.pairing import get_curve
from ..ops import cuda_probe
from ..ops.field import device_field
from .common import (FQ_BYTES, IMAD_PER_FQ_MUL, IMAD_PER_TC_MUL, TC_OPS_PER_MUL, bound,
                     cuda_ms, max_abs_err, rand_field, require_card, smi)

SEED = 20261018
TILES = 256  # tiles of 8 x 128 per launch (probe_mxu.py GRID)
N_MUL = 1 << 20  # elements of the multiply chains (probe_mxu2.py N)


def make_inputs(tiles: int = TILES, n: int = N_MUL, seed: int = SEED, device="cuda"):
    """x (2, 8 tiles, 128) random u32 (P14), x8 (32, 8 tiles, 128) bytes
    (P15), a, b (n, 16) canonical Fq limb rows (P16, P17)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 62)))
    x = torch.randint(-(1 << 31), 1 << 31, (2, 8 * tiles, 128), generator=gen,
                      device=device, dtype=torch.int32)
    x8 = torch.randint(0, 256, (32, 8 * tiles, 128), generator=gen, device=device,
                       dtype=torch.int32)
    df = device_field(get_curve("bn254").fq, device)
    return x, x8, rand_field(rng, n, (df.L,), df, device), rand_field(rng, n, (df.L,), df, device)


def work(kind: str, n: int, nmul: int = 1, n_mm: int = 8) -> tuple:
    """(bytes, integer ops, tensor-core ops) of one launch: P14 over n
    elements (one op a step), P15 over n tiles, P16/P17 over n elements."""
    if kind == "u32":
        return 4 * n * 4, n * cuda_probe.K_OPS, 0
    if kind == "band":
        return 2 * 32 * 8 * 128 * 4 * n, 0, 2 * 256 * 256 * 128 * n * n_mm
    imads = IMAD_PER_FQ_MUL if kind == "cios" else IMAD_PER_TC_MUL
    tc = 0 if kind == "cios" else n * nmul * TC_OPS_PER_MUL
    return 3 * n * FQ_BYTES, n * nmul * imads, tc


def check(device="cuda") -> None:
    """Every kernel against its plain version at edge shapes: P14 for every
    op on 5 x 67 elements (a partial block); P15 at n_mm 1, 8 and 32 on 2
    tiles; P16 and P17 at nmul 1 and 4 on 67 and 1 elements (a partial
    warp), with 0, 1, p - 1 and R mod p among them."""
    rng = np.random.default_rng(SEED + 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 62)))
    errs = {}
    x = torch.randint(-(1 << 31), 1 << 31, (2, 5, 67), generator=gen, device=device,
                      dtype=torch.int32)
    for op in cuda_probe.U32_OPS:
        errs[f"probe_u32_ops {op}"] = max_abs_err(cuda_probe.u32_ops(x, op),
                                                  cuda_probe.u32_ops_plain(x, op))
    m2d = cuda_probe.band_mma_matrix(device)
    x8 = torch.randint(0, 256, (32, 16, 128), generator=gen, device=device, dtype=torch.int32)
    x8[:, :, :2] = torch.randint(-(1 << 31), 1 << 31, (32, 16, 2), generator=gen,
                                 device=device, dtype=torch.int32)
    for n_mm in cuda_probe.MM_STEPS:
        errs[f"probe_band_mma n_mm={n_mm}"] = max_abs_err(
            cuda_probe.band_mma(m2d, x8, n_mm), cuda_probe.band_mma_plain(m2d, x8, n_mm))
    df = device_field(get_curve("bn254").fq, device)
    p = df.spec.modulus
    for n in (67, 1):
        a, b = (rand_field(rng, n, (df.L,), df, device) for _ in range(2))
        k = min(n, 4)
        a[:k] = df.encode([0, 1, p - 1, df.R][:k])
        b[:k] = df.encode([p - 1, p - 1, p - 1, df.R][:k])
        for nmul in (1, 4):
            want = cuda_probe.mul_chain_plain(df, a, b, nmul)
            for red in cuda_probe.REDS:
                errs[f"probe_mul_chain_{red} n={n} nmul={nmul}"] = max_abs_err(
                    cuda_probe.mul_chain(df, a, b, nmul, red), want)
            errs[f"plain tc n={n} nmul={nmul}"] = max_abs_err(
                cuda_probe.mul_chain_plain(df, a, b, nmul, "tc"), want)
    bad = [name for name, e in errs.items() if e]
    if bad:
        raise AssertionError(f"mxu probe kernels != plain versions: {bad}")


def measure(iters: int = 10, device="cuda") -> dict:
    """Time P14 (every op), P15 (n_mm 8, 32), P16 and P17 (flat, chain4)."""
    card = smi()
    x, x8, a, b = make_inputs(TILES, N_MUL, SEED, device)
    df = device_field(get_curve("bn254").fq, device)
    n_el = x.numel() // 2
    print(f"mxu probe: {TILES} tiles of 8 x 128, {cuda_probe.K_OPS} u32 steps; "
          f"{N_MUL} Fq products [{card}]", flush=True)
    rows = []

    def row(label, ms, work_, **extra):
        b_ = bound(*work_)
        rows.append({"variant": label, "ms": ms, **b_, "share": b_["bound_ms"] / ms, **extra})
        more = "".join(f", {k} {v:.6g}" for k, v in extra.items())
        print(f"  {label}: {ms:.6f} ms, bound {b_['bound_ms']:.6f} ms ({b_['bound_by']}), "
              f"share {b_['bound_ms'] / ms:.4f}{more}", flush=True)

    for op in cuda_probe.U32_OPS:  # tens of microseconds: 10x the runs
        ms = cuda_ms(lambda op=op: cuda_probe.u32_ops(x, op), 10 * iters)
        row(f"P14 {op} x{cuda_probe.K_OPS}", ms, work("u32", n_el),
            tsteps_per_s=n_el * cuda_probe.K_OPS / ms / 1e9)
    m2d = cuda_probe.band_mma_matrix(device)
    for n_mm in (8, 32):
        ms = cuda_ms(lambda n_mm=n_mm: cuda_probe.band_mma(m2d, x8, n_mm), iters)
        row(f"P15 band matmul x{n_mm}", ms, work("band", TILES, n_mm=n_mm),
            us_per_matmul=ms * 1e3 / (TILES * n_mm))
    for nmul, label in ((1, "flat"), (4, "chain4")):
        outs = {}
        for red, pid in (("cios", "P16"), ("tc", "P17")):
            outs[red] = cuda_probe.mul_chain(df, a, b, nmul, red)
            ms = cuda_ms(lambda red=red: cuda_probe.mul_chain(df, a, b, nmul, red), iters)
            row(f"{pid} {label} {red}", ms, work(red, N_MUL, nmul),
                gmul_per_s=N_MUL * nmul / ms / 1e6)
        if max_abs_err(outs["tc"], outs["cios"]):
            raise AssertionError(f"mxu probe: P17 != P16 ({label})")
    out = {"tiles": TILES, "n_mul": N_MUL, "card": card, "variants": rows}
    print(json.dumps({"mxu_probe": out}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10, help="timed runs of each variant")
    args = ap.parse_args(argv)
    if not require_card("mxu probe"):
        return 2
    check()
    measure(args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Window probe: where the time of one MSM window goes on the card.

    python3 -m ckb_zkp_tpu_torch.probes.window [--log2 21] [--c 16] [--iters 5]

The port of the JAX package's `scripts/probe_window.py` and
`scripts/probe_window2.py`: BN254 G1, N = 2^log2 points with random
coordinates below p (off the curve: the timing does not care), 1/1024 of
them flagged at infinity, and one row of random c-bit digits. It prints,
each in ms by CUDA events on one stream:

- the components of a window: the sort of the digits, the (N, 16) row
  gather of limb rows, the bucket ends (counts and their prefix), K2a
  through `_scan_prefix_madd`, the boundary prefix over the block totals
  T, the reduce over 2^c points and the `w_get` gather of 2^c prefixes;
- the cumulative stages A-E of one real window, with K2b on packed leaves
  and a flag array: A the sort, B + the gathers of the packed coordinates
  and the flags, C + K2b, D + the bucket ends, the boundary prefixes and
  the bucket-end points E_b, E + the weighting (the window sum).

Stage E's window sum must equal the prover's `DeviceCurveGroup._windows`
(K2 on leaves carrying the flag in bit 31) on the same points and digits,
limb for limb; the probe raises if it does not, so it measures the window
the prover runs. Before timing, K2a and K2b are held against their plain
versions at edge shapes (`check`). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..host.pairing import get_curve
from ..ops import cuda_rcb
from ..ops.limbs import pack_limbs
from ..ops.msm import (_RCB_B, _boundary_before, _bucket_ends, _reduce_pts,
                       _scan_prefix_madd, device_group)
from .common import cuda_ms, max_abs_err, rand_field, require_card, smi

SEED = 20261016
STAGES = ("A sort", "B +gathers", "C +K2b scan", "D +boundaries, w_get, E_b",
          "E full window")


def make_inputs(dg, log2: int, c: int, seed: int = SEED, device="cuda"):
    """(X, Y, inf, digits): N = 2^log2 G1 limb rows below p, flags (1/1024
    set) and one (1, N) row of c-bit digits."""
    rng = np.random.default_rng(seed)
    n = 1 << log2
    X = rand_field(rng, n, dg.cf.coord_shape, dg.fq, device)
    Y = rand_field(rng, n, dg.cf.coord_shape, dg.fq, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 62)))
    inf = torch.rand(n, generator=gen, device=device) < 1 / 1024
    digits = torch.randint(0, 1 << c, (1, n), generator=gen, device=device)
    return X, Y, inf, digits


def window_stages(dg, X, Y, inf, digits, c: int) -> dict:
    """The cumulative stages A-E of one window (STAGES: name -> fn), with
    K2b on the leaves packed by `pack_limbs` and the flag array."""
    rg = dg.rg
    k, npad = digits.shape
    xw, yw = (pack_limbs(t.reshape(npad, -1)) for t in (X, Y))

    def a():
        return torch.sort(digits, dim=1).indices

    def b():
        order = a()
        return (xw[order].reshape(k * npad, -1), yw[order].reshape(k * npad, -1),
                inf[order].reshape(-1))

    def c_():
        return cuda_rcb.scan_prefix_madd_packed(rg, *b(), _RCB_B)

    def d():
        return dg._bucket_prefixes(*c_(), digits, c)

    def e():
        return dg._weigh_buckets(d(), c)

    return dict(zip(STAGES, (a, b, c_, d, e)))


def window_components(dg, X, Y, inf, digits, c: int) -> dict:
    """The components of one window (name -> fn) on the same inputs."""
    rg = dg.rg
    nb = 1 << c
    order = torch.sort(digits, dim=1).indices[0]
    w_get, T = _scan_prefix_madd(rg, (X, Y, inf), _RCB_B)
    qc = _bucket_ends(digits, nb).clamp(min=0)
    j = torch.div(qc, _RCB_B, rounding_mode="floor") - 1
    ident_q = rg.identity((1, nb))
    Tk = tuple(t.unsqueeze(0) for t in T)
    E = _boundary_before(rg, Tk, j, ident_q)
    return {
        "sort": lambda: torch.sort(digits, dim=1).indices,
        "row gather (N, 16)": lambda: X[order],
        "bucket ends": lambda: _bucket_ends(digits, nb),
        "K2a _scan_prefix_madd": lambda: _scan_prefix_madd(rg, (X, Y, inf), _RCB_B),
        "boundary prefix over T": lambda: _boundary_before(rg, Tk, j, ident_q),
        f"reduce over 2^{c} points": lambda: _reduce_pts(rg, E),
        "w_get gather": lambda: w_get(qc[0]),
    }


def check_window_sum(dg, X, Y, inf, digits, c: int) -> None:
    """Stage E against the prover's `_windows`, limb for limb."""
    got = window_stages(dg, X, Y, inf, digits, c)[STAGES[-1]]()
    n = X.shape[0]
    xp, yp = cuda_rcb.pack_limbs_flag(dg.rg, X.reshape(n, -1), Y.reshape(n, -1), inf)
    want = dg._windows(xp, yp, digits, c)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("window probe: stage E != DeviceCurveGroup._windows")


def check(device="cuda") -> None:
    """K2a and K2b against their plain versions, G1 and G2, at edge shapes:
    1/10 of the leaves flagged and the first block all flagged (B = 32),
    B = 5 tail blocks, one block of B = n = 7; and stage E against
    `_windows`."""
    curve = get_curve("bn254")
    rng = np.random.default_rng(SEED + 1)
    for group in ("g1", "g2"):
        dg = device_group(curve, group, device)
        rg, cs = dg.rg, dg.cf.coord_shape
        for n, B in ((1 << 12, 32), (5 * 64, 5), (7, 7)):
            X, Y = (rand_field(rng, n, cs, dg.fq, device) for _ in range(2))
            inf = torch.as_tensor(rng.random(n) < 0.1, device=device)
            inf[:B] = n > B  # an all-flagged block where there are several
            xw, yw = (pack_limbs(t.reshape(n, -1)) for t in (X, Y))
            for name, args in (("scan_prefix_madd_unpacked", (X, Y)),
                               ("scan_prefix_madd_packed", (xw, yw))):
                got = getattr(cuda_rcb, name)(rg, *args, inf, B)
                want = getattr(cuda_rcb, name + "_plain")(rg, *args, inf, B)
                if max_abs_err(got[0] + got[1], want[0] + want[1]):
                    raise AssertionError(f"{name} != its plain version ({group}, n={n})")
    dg = device_group(curve, "g1", device)
    check_window_sum(dg, *make_inputs(dg, 12, 8, SEED + 2, device), 8)


def measure(log2: int = 21, c: int = 16, iters: int = 5, device="cuda") -> dict:
    """Time the components and the stages of one 2^log2-point G1 window,
    after checking stage E against `_windows` on these inputs."""
    card = smi()
    dg = device_group(get_curve("bn254"), "g1", device)
    inputs = make_inputs(dg, log2, c, SEED, device)
    check_window_sum(dg, *inputs, c)
    print(f"window probe: N = 2^{log2}, c = {c}, G1; stage E equals _windows [{card}]",
          flush=True)
    out = {"log2": log2, "c": c, "card": card, "components_ms": {}, "stages_ms": {}}
    for key, fns in (("components_ms", window_components(dg, *inputs, c)),
                     ("stages_ms", window_stages(dg, *inputs, c))):
        for name, fn in fns.items():
            out[key][name] = ms = cuda_ms(fn, iters)
            print(f"  {name}: {ms:.6f} ms", flush=True)
    print(json.dumps({"window_probe": out}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2", type=int, default=21, help="log2 of the points (21)")
    ap.add_argument("--c", type=int, default=16, help="window bits (16)")
    ap.add_argument("--iters", type=int, default=5, help="timed runs of each item")
    args = ap.parse_args(argv)
    if not require_card("window probe"):
        return 2
    check()
    measure(args.log2, args.c, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The scan probes' kernels (P-tot, P-prepk, P-chain): wrappers, plain
versions and launch counters.

They replace the Pallas probe kernels of `scripts/probe_scan.py`,
`probe_scan2.py` and `probe_scan7.py` (`csrc/probe_scan.cu`):

- P-tot (`madd_totals`): K2b's block totals only, the blocked mixed-add
  scan over packed affine leaves with a bool flag array, without W.
- P-prepk (`madd_prefix_packed`): K2b with every inclusive prefix W
  written as packed words, R/2 per coordinate (`pack_limbs`' layout).
- P-chain (`chain_mul`): per block-column g of B limb rows, acc = x[g, 0],
  then acc = acc * x[g, b] * R^-1 for b = 0 .. B-1 (leaf 0 enters twice,
  as in the reference).

`k` (1, 2 or 4) is the number of block-columns each thread interleaves,
`threads` (32, 64, 128 or 256) the threads per block: both change how the
card runs the function, never its value, so each plain version ignores
them. The kernels are instantiated for G1 (Fq) only, as the probes are G1.
Layouts are the port's scans' (`cuda_rcb`): element e = g*B + b.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .cuda_rcb import _check_blocks, _scan_plain, scan_prefix_madd_packed_plain, unpack_coord
from .limbs import pack_limbs

CHAINS = (1, 2, 4)
THREADS = (32, 64, 128, 256)


def _check_options(k: int, threads: int) -> None:
    if k not in CHAINS or threads not in THREADS:
        raise ValueError(f"probe: k = {k} not in {CHAINS} or threads = {threads} "
                         f"not in {THREADS}")


def _madd_launch(rg, xw, yw, inf, B: int, k: int, threads: int, with_w: bool):
    if rg.cf.ext != 1:
        raise ValueError("probe kernels are instantiated for G1 (Fq) only")
    _check_options(k, threads)
    M = xw.shape[0]
    _check_blocks(M, B)
    xw, yw, inf = xw.contiguous(), yw.contiguous(), inf.contiguous()
    cuda_build.check_tensor(xw, "probe x")
    cuda_build.check_tensor(yw, "probe y", xw.shape)
    cuda_build.check_tensor(inf, "probe flags", (M,), torch.bool)
    dev, L = xw.device, rg.cf.L
    W = tuple(torch.empty_like(xw) for _ in range(3)) if with_w else (None,) * 3
    T = tuple(torch.empty((M // B, L), dtype=torch.int32, device=dev) for _ in range(3))
    ptr = [None if t is None else t.data_ptr() for t in (*W, *T)]
    rc = cuda_build.lib().zkp_probe_madd_scan(
        rg.kconsts.ctypes.data, rg.cf.ext, k, int(with_w), threads, *ptr,
        xw.data_ptr(), yw.data_ptr(), inf.data_ptr(), M // B, B,
        cuda_build.stream_ptr(xw))
    return rc, W, T


def madd_totals(rg, xw, yw, inf, B: int, k: int = 1, threads: int = 64):
    """P-tot: packed leaves xw, yw (M, R/2) and flags inf (M,) -> T (G,)."""
    if xw.device.type == "cpu":
        return madd_totals_plain(rg, xw, yw, inf, B)
    rc, _, T = _madd_launch(rg, xw, yw, inf, B, k, threads, False)
    cuda_build.COUNTS["probe_madd_totals"] += 1
    cuda_build.check(rc, "probe_madd_totals")
    return T


def madd_prefix_packed(rg, xw, yw, inf, B: int, k: int = 1, threads: int = 64):
    """P-prepk: packed leaves and flags -> (W (M, R/2) packed words x3,
    T (G,))."""
    if xw.device.type == "cpu":
        return madd_prefix_packed_plain(rg, xw, yw, inf, B)
    rc, W, T = _madd_launch(rg, xw, yw, inf, B, k, threads, True)
    cuda_build.COUNTS["probe_madd_prefix_packed"] += 1
    cuda_build.check(rc, "probe_madd_prefix_packed")
    return W, T


def chain_mul(df, x, B: int, k: int = 1, threads: int = 64):
    """P-chain: (M = G*B, L) canonical limb rows -> (G, L) chain products."""
    M = x.shape[0]
    _check_blocks(M, B)
    if x.device.type == "cpu":
        return chain_mul_plain(df, x, B)
    _check_options(k, threads)
    x = x.contiguous()
    cuda_build.check_tensor(x, "probe chain x", (M, df.L))
    out = torch.empty((M // B, df.L), dtype=torch.int32, device=x.device)
    rc = cuda_build.lib().zkp_probe_chain_mul(
        df.kconsts.ctypes.data, k, threads, out.data_ptr(), x.data_ptr(), M // B, B,
        cuda_build.stream_ptr(x))
    cuda_build.COUNTS["probe_chain_mul"] += 1
    cuda_build.check(rc, "probe_chain_mul")
    return out


def madd_totals_plain(rg, xw, yw, inf, B: int):
    rgp = rg.plain
    leaves = (unpack_coord(rg, xw), unpack_coord(rg, yw), inf)
    return _scan_plain(rgp, leaves, B, rgp.madd, False)[1]


def madd_prefix_packed_plain(rg, xw, yw, inf, B: int):
    W, T = scan_prefix_madd_packed_plain(rg, xw, yw, inf, B)
    return tuple(pack_limbs(w.reshape(w.shape[0], -1)) for w in W), T


def chain_mul_plain(df, x, B: int):
    dfp = df.plain
    xb = x.reshape(x.shape[0] // B, B, df.L)
    acc = xb[:, 0]
    for b in range(B):
        acc = dfp.mul(acc, xb[:, b])
    return acc

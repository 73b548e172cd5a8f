"""The probes' kernels: wrappers, plain versions and launch counters.

They replace the Pallas probe kernels of `scripts/probe_scan*.py`,
`probe_mxu.py` and `probe_mxu2.py` (`csrc/probe_scan.cu`,
`csrc/probe_mxu.cu`):

- P-tot (`madd_totals`): K2b's block totals only, the blocked mixed-add
  scan over packed affine leaves with a bool flag array, without W; with
  ``red="tc"`` the multiplies go through the tensor-core reduction (P19).
- P-prepk (`madd_prefix_packed`): K2b with every inclusive prefix W
  written as packed words, R/2 per coordinate (`pack_limbs`' layout).
- P-chain (`chain_mul`): per block-column g of B limb rows, acc = x[g, 0],
  then acc = acc * x[g, b] * R^-1 for b = 0 .. B-1 (leaf 0 enters twice,
  as in the reference).
- g-major P-tot and P-prepk (`gmajor_totals`, P12, and with ``red="tc"``
  P18; `gmajor_prefix`, P13, W as one (M, 3 R/2) array, X|Y|Z words
  adjacent per leaf): the same functions on leaves in the g-major order of
  `gmajor_index`.
- P14 (`u32_ops`): 512 chained wrapping u32 steps per element.
- P15 (`band_mma`): chained int8 band-matrix products per 256-row tile.
- P16 / P17 (`mul_chain`): nmul chained Montgomery products a = a * b *
  R^-1, CIOS (P16) or the tensor-core reduction (P17).

`k` (1, 2 or 4) is the number of block-columns each thread interleaves,
`threads` (32, 64, 128 or 256) the threads per block: both change how the
card runs the function, never its value, so each plain version ignores
them, except that the g-major order depends on `threads` (the columns of
one block). The kernels are instantiated for G1 (Fq) only, as the probes
are G1. The column-major layout is the port's scans' (`cuda_rcb`): leaf
e = g*B + b.
"""

from __future__ import annotations

import torch

import numpy as np

from . import cuda_build
from .cuda_field import mont_mul_plain
from .cuda_rcb import _check_blocks, _scan_plain, scan_prefix_madd_packed_plain, unpack_coord
from .limbs import _u32_to_i32, pack_limbs
from .mont_tc import exact_matmul, fragments, mont_mul_tc_plain

CHAINS = (1, 2, 4)
THREADS = (32, 64, 128, 256)
REDS = ("cios", "tc")


def _check_options(k: int, threads: int) -> None:
    if k not in CHAINS or threads not in THREADS:
        raise ValueError(f"probe: k = {k} not in {CHAINS} or threads = {threads} "
                         f"not in {THREADS}")


def _madd_launch(rg, xw, yw, inf, B: int, k: int, threads: int, with_w: bool,
                 layout: int = 0, red: str = "cios"):
    if rg.cf.ext != 1:
        raise ValueError("probe kernels are instantiated for G1 (Fq) only")
    _check_options(k, threads)
    if red not in REDS:
        raise ValueError(f"probe: red = {red!r} not in {REDS}")
    M = xw.shape[0]
    _check_blocks(M, B)
    xw, yw, inf = xw.contiguous(), yw.contiguous(), inf.contiguous()
    cuda_build.check_tensor(xw, "probe x")
    cuda_build.check_tensor(yw, "probe y", xw.shape)
    cuda_build.check_tensor(inf, "probe flags", (M,), torch.bool)
    dev, L = xw.device, rg.cf.L
    if not with_w:
        W = (None,) * 3
    elif layout == 1:
        W = (torch.empty((M, 3 * xw.shape[1]), dtype=torch.int32, device=dev), None, None)
    else:
        W = tuple(torch.empty_like(xw) for _ in range(3))
    T = tuple(torch.empty((M // B, L), dtype=torch.int32, device=dev) for _ in range(3))
    frag = fragments(rg.df, dev) if red == "tc" else None
    ptr = [None if t is None else t.data_ptr() for t in (*W, *T)]
    rc = cuda_build.lib().zkp_probe_madd_scan(
        rg.kconsts.ctypes.data, None if frag is None else frag.data_ptr(), rg.cf.ext, k,
        int(with_w), layout, REDS.index(red), threads, *ptr,
        xw.data_ptr(), yw.data_ptr(), inf.data_ptr(), M // B, B,
        cuda_build.stream_ptr(xw))
    return rc, W, T


def madd_totals(rg, xw, yw, inf, B: int, k: int = 1, threads: int = 64,
                red: str = "cios"):
    """P-tot: packed leaves xw, yw (M, R/2) and flags inf (M,) -> T (G,);
    red="tc" (P19, k = 1) runs the multiplies on the tensor cores."""
    if xw.device.type == "cpu":
        return madd_totals_plain(rg, xw, yw, inf, B)
    if red == "tc" and k != 1:
        raise ValueError("probe: the tensor-core P-tot runs k = 1 only")
    rc, _, T = _madd_launch(rg, xw, yw, inf, B, k, threads, False, 0, red)
    name = "probe_madd_totals_tc" if red == "tc" else "probe_madd_totals"
    cuda_build.COUNTS[name] += 1
    cuda_build.check(rc, name)
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


def gmajor_index(G: int, B: int, cols: int, device="cpu") -> torch.Tensor:
    """(G*B,) int64: the g-major position of column-major element g*B + b.
    Blocks of `cols` columns (fewer in a ragged last block, w of them) hold
    their leaves as one run, step-major: position first*B + b*w + (g -
    first), first = the block's first column."""
    g = torch.arange(G, dtype=torch.int64, device=device).unsqueeze(1)
    b = torch.arange(B, dtype=torch.int64, device=device).unsqueeze(0)
    first = g // cols * cols
    w = torch.clamp(G - first, max=cols)
    return (first * B + b * w + (g - first)).reshape(-1)


def to_gmajor(x, B: int, cols: int):
    """Rows of x (M = G*B, ...) from the column-major to the g-major order."""
    out = torch.empty_like(x)
    out[gmajor_index(x.shape[0] // B, B, cols, x.device)] = x
    return out


def from_gmajor(x, B: int, cols: int):
    """Rows of x from the g-major order back to the column-major order."""
    return x[gmajor_index(x.shape[0] // B, B, cols, x.device)]


def gmajor_totals(rg, xw, yw, inf, B: int, threads: int = 64, red: str = "cios"):
    """P12 (red="cios") and P18 (red="tc"): P-tot on leaves in the g-major
    order of `threads` columns per block -> T (G,) by column."""
    if xw.device.type == "cpu":
        return gmajor_totals_plain(rg, xw, yw, inf, B, threads)
    rc, _, T = _madd_launch(rg, xw, yw, inf, B, 1, threads, False, 1, red)
    name = "probe_gmajor_totals_tc" if red == "tc" else "probe_gmajor_totals"
    cuda_build.COUNTS[name] += 1
    cuda_build.check(rc, name)
    return T


def gmajor_prefix(rg, xw, yw, inf, B: int, threads: int = 64):
    """P13: P-prepk on g-major leaves -> (W (M, 3 R/2) g-major, X|Y|Z packed
    words adjacent per leaf, T (G,))."""
    if xw.device.type == "cpu":
        return gmajor_prefix_plain(rg, xw, yw, inf, B, threads)
    rc, W, T = _madd_launch(rg, xw, yw, inf, B, 1, threads, True, 1)
    cuda_build.COUNTS["probe_gmajor_prefix"] += 1
    cuda_build.check(rc, "probe_gmajor_prefix")
    return W[0], T


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


def mul_chain(df, a, b, nmul: int, red: str = "cios"):
    """P16 (red="cios") and P17 (red="tc"): (N, L) canonical limb rows a, b
    -> a after nmul (1 or 4) chained a = a * b * R^-1."""
    if a.device.type == "cpu":
        return mul_chain_plain(df, a, b, nmul, red)
    if nmul not in (1, 4) or red not in REDS:
        raise ValueError(f"probe: nmul = {nmul} not in (1, 4) or red = {red!r} "
                         f"not in {REDS}")
    a, b = a.contiguous(), b.contiguous()
    cuda_build.check_tensor(a, "probe mul a", (a.shape[0], df.L))
    cuda_build.check_tensor(b, "probe mul b", a.shape)
    out = torch.empty_like(a)
    frag = fragments(df, a.device) if red == "tc" else None
    rc = cuda_build.lib().zkp_probe_mul_chain(
        df.kconsts.ctypes.data, None if frag is None else frag.data_ptr(), nmul,
        REDS.index(red), out.data_ptr(), a.data_ptr(), b.data_ptr(), a.shape[0],
        cuda_build.stream_ptr(a))
    name = f"probe_mul_chain_{red}"
    cuda_build.COUNTS[name] += 1
    cuda_build.check(rc, name)
    return out


U32_OPS = ("add", "mul", "mulmask", "shift")
K_OPS = 512  # steps per element (probe_mxu.py K_OPS)


def u32_ops(x, op: str):
    """P14: x (2, ...) u32 bit patterns in int32 -> out with out[0] = a
    after K_OPS wrapping steps of `op` on (a, b) = (x[0], x[1]), out[1] =
    b."""
    if x.device.type == "cpu":
        return u32_ops_plain(x, op)
    if op not in U32_OPS:
        raise ValueError(f"probe: op = {op!r} not in {U32_OPS}")
    x = x.contiguous()
    cuda_build.check_tensor(x, "probe u32 x")
    out = torch.empty_like(x)
    rc = cuda_build.lib().zkp_probe_u32_ops(
        U32_OPS.index(op), out.data_ptr(), x.data_ptr(), x.numel() // 2,
        cuda_build.stream_ptr(x))
    cuda_build.COUNTS["probe_u32_ops"] += 1
    cuda_build.check(rc, "probe_u32_ops")
    return out


def u32_ops_plain(x, op: str):
    """Plain P14 in int64 masked to 32 bits (torch on the CPU has no uint32
    add); the result's bit patterns as int32."""
    m32 = 0xFFFFFFFF
    a, b = (v.to(torch.int64) & m32 for v in (x[0], x[1]))
    for i in range(K_OPS):
        if op == "mul":
            a = (a * b + i) & m32
        elif op == "add":
            a = (a + b + i) & m32
        elif op == "shift":
            a = ((a >> 16) + b + i) & m32
        elif op == "mulmask":
            p = (a * b) & m32
            a = ((p & 0xFFFF) + (p >> 16) + i) & m32
        else:
            raise ValueError(f"probe: op = {op!r} not in {U32_OPS}")
    return _u32_to_i32(torch.stack([a, b]))


MM_ROWS, MM_SB, MM_LANES = 256, 8, 128  # the tile: 32 byte planes x 8 sublanes
MM_STEPS = (1, 8, 32)


def band_mma_matrix(device="cuda"):
    """The reference's M2d: default_rng(1) int8 (256, 256) (`probe_mxu.py`
    `make_mxu`)."""
    rng = np.random.default_rng(1)
    m = rng.integers(-128, 128, (MM_ROWS, MM_ROWS), dtype=np.int8)
    return torch.as_tensor(m, device=device)


def band_mma(m2d, x, n_mm: int):
    """P15: m2d (256, 256) int8, x (32, 8 * tiles, 128) u32 bit patterns in
    int32 -> t after n_mm (1, 8 or 32) steps on each tile, same shape."""
    if x.device.type == "cpu":
        return band_mma_plain(m2d, x, n_mm)
    if n_mm not in MM_STEPS:
        raise ValueError(f"probe: n_mm = {n_mm} not in {MM_STEPS}")
    x, m2d = x.contiguous(), m2d.contiguous()
    planes, rows, lanes = x.shape
    if (planes * MM_SB != MM_ROWS or rows % MM_SB or lanes != MM_LANES
            or tuple(m2d.shape) != (MM_ROWS, MM_ROWS)):
        raise ValueError(f"probe: band_mma takes x (32, 8 n, 128) and m2d (256, 256), "
                         f"got {tuple(x.shape)}, {tuple(m2d.shape)}")
    cuda_build.check_tensor(x, "probe band x")
    cuda_build.check_tensor(m2d, "probe band m2d", dtype=torch.int8)
    out = torch.empty_like(x)
    rc = cuda_build.lib().zkp_probe_band_mma(
        n_mm, out.data_ptr(), m2d.data_ptr(), x.data_ptr(), rows // MM_SB,
        cuda_build.stream_ptr(x))
    cuda_build.COUNTS["probe_band_mma"] += 1
    cuda_build.check(rc, "probe_band_mma")
    return out


def band_mma_plain(m2d, x, n_mm: int):
    """Plain P15 per tile: int64, the products by `exact_matmul` (on the card
    in float64: |M2d| <= 128 and |t8| <= 128, so a 256-term sum is below
    2^22 < 2^53, asserted)."""
    assert MM_ROWS * 128 * 128 < (1 << 23)
    planes, rows, lanes = x.shape
    nt = rows // MM_SB
    # (tiles, 256 rows = plane * 8 + sublane, 128)
    t = (x.to(torch.int64).reshape(planes, nt, MM_SB, lanes).permute(1, 0, 2, 3)
         .reshape(nt, MM_ROWS, lanes))
    m = m2d.to(torch.int64)
    acc = torch.zeros_like(t)
    for i in range(n_mm):
        tb = t & 0xFF
        o = exact_matmul(tb.transpose(1, 2) - 128, m).transpose(1, 2)
        acc = acc + o + tb.sum(1, keepdim=True) + i
        t = acc.abs() & 0xFFFF
    return (t.reshape(nt, planes, MM_SB, lanes).permute(1, 0, 2, 3)
            .reshape(planes, rows, lanes).to(torch.int32))


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


def gmajor_totals_plain(rg, xw, yw, inf, B: int, threads: int):
    """Plain P12/P18: the plain P-tot on the leaves in the column-major order."""
    return madd_totals_plain(rg, *(from_gmajor(v, B, threads) for v in (xw, yw, inf)), B)


def gmajor_prefix_plain(rg, xw, yw, inf, B: int, threads: int):
    """Plain P13: the plain P-prepk, W joined X|Y|Z per leaf and put in
    the g-major order."""
    W, T = madd_prefix_packed_plain(
        rg, *(from_gmajor(v, B, threads) for v in (xw, yw, inf)), B)
    return to_gmajor(torch.cat(W, dim=1), B, threads), T


def mul_chain_plain(df, a, b, nmul: int, red: str = "cios"):
    """Plain P16 (K1's plain multiply) and P17 (the plain byte-band
    reduction, `mont_tc.mont_mul_tc_plain`)."""
    mul = mont_mul_tc_plain if red == "tc" else mont_mul_plain
    for _ in range(nmul):
        a = mul(df, a, b)
    return a

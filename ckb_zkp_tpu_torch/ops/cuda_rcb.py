"""K5 (elementwise RCB add), K6 (elementwise RCB mixed add) and K2/K3/K4
(blocked RCB scans): wrappers, plain versions and launch counters.

K5 replaces `ops/pallas_rcb.py` `_add_kernel` (via `_add_fn`, entry
`rcb_add_pallas`): Alg. 7 on each pair of points, one pair a team of lanes
(`csrc/rcb_team.cuh`, launched by `csrc/rcb_add.cu`), one product of a
level of Alg. 7 a lane, because the MSM's launches of 1-64 points leave a
thread running Alg. 7's twelve products in a row bound by their latency.

K6 replaces `ops/pallas_rcb.py:204` `_madd_kernel` (via `_madd_fn`, entry
`rcb_madd_pallas`) in two entries. The elementwise one (`rcb_madd`,
`csrc/rcb_madd.cu`): one thread per element runs Alg. 8 (11 multiplies) on
a projective point and an affine point, and keeps the projective point
where the affine one's infinity flag (a bool array of the batch shape) is
set; `RcbGroup.madd` calls it, the setup does not. The fixed-base MSM
(`rcb_fixed_base`, `csrc/rcb_fixed_base.cu`), as the reference's
`_fixed_base_rcb` (`ops/msm.py:901`) runs `_madd_kernel` once a window:
each point's 32 windows in one launch, a chain of mixed adds from the
identity over the window-table rows its scalar's 8-bit digits pick, read
in the kernel (one thread a point for G1, the team of lanes of
`csrc/rcb_team.cuh` for G2). The setup's `fixed_base_msm` calls it once a
query.

K2, K3 and K4 replace three `_scan_fn` kernels of `ops/pallas_rcb.py`:
`_scan_prefix_madd_packedf_kernel` (K2, sorted affine leaves packed two
limbs per word with the infinity flag in bit 31 of the top X word, mixed
add), `_scan_prefix_add_kernel` (K3, projective leaves) and
`_scan_total_add_kernel` (K4, block totals only): block g of B elements is
folded from the identity (0 : 1 : 0), writing every inclusive prefix
W[g*B + b] and the block total T[g]. On Hopper all three run on a team of
lanes a chain (`csrc/rcb_team.cuh` via `csrc/rcb_team_scan.cu`, modes 0-2
of `zkp_rcb_scan`): 8 lanes, each one Fq or Fq2 product of a level of Alg.
8 (K2) or Alg. 7 (K3, K4); for G2 at few chains a warp, each Fq2 product
split into Karatsuba's three. K2 reads its leaves through the sort order
(`order`): leaf e of the scan is row order[e] of the unsorted packed arrays,
so no sorted copy is written for it. K2a (`_scan_prefix_madd_kernel`,
`:275`) and K2b (`_scan_prefix_madd_packed_kernel`, `:225`) are K2 with the
flags in a separate bool array, over limb rows (K2a, twice K2b's leaf
bytes) or packed words (K2b); the window probes launch them, and they keep
the first port's design (`csrc/rcb_scan.cu` `rcb_scan_kernel`, modes 3 and
4: one thread a chain). W is indexed by position, T by block, as in the
reference. The MSM widens K2's grid by scanning all of a batch of windows
in one launch.

Layouts: points are tuples (X, Y, Z) of (M, L) or (M, 2, L) int32 limb
tensors; packed leaves are (M, R/2) int32 words (R = ext * L).
"""

from __future__ import annotations

import math

import torch

from . import cuda_build
from .limbs import MASK, pack_limbs, unpack_words


def _launch_args(ts):
    return [None if t is None else t.data_ptr() for t in ts]


# ------------------------------------------------------------------ K5
def launch_pairwise(entry: str, count: str, kconsts, cf, p, q, *lead):
    """Launch an elementwise kernel of two points (K5, K8) on broadcast
    (X, Y, Z) operands; the C entry takes (consts, ext, *lead, out x3, p x3,
    q x3, n, stream) (K8's lead: its one-thread flag)."""
    cs = cf.coord_shape
    shape = torch.broadcast_shapes(*(c.shape for c in (*p, *q)))
    coords = [c.expand(shape).contiguous() for c in (*p, *q)]
    for i, c in enumerate(coords):
        cuda_build.check_tensor(c, f"{count} operand {i}")
    out = [torch.empty(shape, dtype=torch.int32, device=coords[0].device)
           for _ in range(3)]
    n = out[0].numel() // math.prod(cs)
    if n == 0:
        return tuple(out)
    rc = getattr(cuda_build.lib(), entry)(
        kconsts.ctypes.data, cf.ext, *lead, *_launch_args(out), *_launch_args(coords),
        n, cuda_build.stream_ptr(out[0]),
    )
    cuda_build.count(count, kconsts)
    cuda_build.check(rc, count)
    return tuple(out)


def rcb_add(rg, p, q):
    """Elementwise complete projective add: K5 on CUDA, plain on CPU."""
    if p[0].device.type == "cpu":
        return rcb_add_plain(rg, p, q)
    return launch_pairwise("zkp_rcb_add", "rcb_add", rg.kconsts, rg.cf, p, q)


def rcb_add_plain(rg, p, q):
    """Plain K5: Alg. 7 as torch ops over the plain field."""
    return rg.plain.add_formula(p, q)


# ------------------------------------------------------------------ K6
def launch_mixed(entry: str, count: str, kconsts, cf, p, q_affine):
    """Launch an elementwise kernel of a point and an affine point with an
    infinity flag (K6, K9a). Operands broadcast against each other as in
    the reference's `rcb_madd_pallas` (`ops/pallas_rcb.py:543-563`); the
    flag has the batch shape only. The C entry takes (consts, ext, out x3,
    p x3, x2, y2, flags, n, stream)."""
    x2, y2, inf2 = q_affine
    cs = cf.coord_shape
    nd = len(cs)
    batch = torch.broadcast_shapes(
        *(c.shape[: c.dim() - nd] for c in (*p, x2, y2)), inf2.shape)
    shape = (*batch, *cs)
    coords = [c.expand(shape).contiguous() for c in (*p, x2, y2)]
    flags = torch.as_tensor(inf2, device=coords[0].device).expand(batch).contiguous()
    for i, c in enumerate(coords):
        cuda_build.check_tensor(c, f"{count} operand {i}")
    cuda_build.check_tensor(flags, f"{count} flags", batch, torch.bool)
    out = [torch.empty(shape, dtype=torch.int32, device=coords[0].device)
           for _ in range(3)]
    n = math.prod(batch)
    if n == 0:
        return tuple(out)
    rc = getattr(cuda_build.lib(), entry)(
        kconsts.ctypes.data, cf.ext, *_launch_args(out),
        *_launch_args(coords), flags.data_ptr(), n,
        cuda_build.stream_ptr(out[0]),
    )
    cuda_build.COUNTS[count] += 1
    cuda_build.check(rc, count)
    return tuple(out)


def rcb_madd(rg, p, q_affine):
    """Elementwise p + (x2, y2, inf): K6 on CUDA, plain on CPU."""
    if p[0].device.type == "cpu":
        return rcb_madd_plain(rg, p, q_affine)
    return launch_mixed("zkp_rcb_madd", "rcb_madd", rg.kconsts, rg.cf, p, q_affine)


def rcb_madd_plain(rg, p, q_affine):
    """Plain K6: Alg. 8 and the flag select as torch ops over the plain
    field (the port's `RcbGroup.plain.madd`)."""
    return rg.plain.madd_formula(p, q_affine)


# ------------------------------------------- K6, the fixed-base MSM
FB_WINDOWS = 32  # 8-bit digits of a 256-bit scalar (csrc/rcb_team.cuh kFbWin)
FB_ROWS = 256  # table rows a window (kFbRows)
FB_LIMBS = 16  # 16-bit limbs a scalar (kFbLimbs)


def check_fixed_base(cf, X, Y, scalars, what: str = "rcb_fixed_base"):
    """The fixed-base operands: tables (32, 256, *coord_shape), scalars
    (n, 16) limbs (K6's and K9a's fixed-base kernels)."""
    shape = (FB_WINDOWS, FB_ROWS, *cf.coord_shape)
    for name, t in (("X", X), ("Y", Y)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: table {name} {tuple(t.shape)} != {shape}")
    if scalars.dim() != 2 or scalars.shape[1] != FB_LIMBS:
        raise ValueError(f"{what}: scalars {tuple(scalars.shape)} are not "
                         f"(n, {FB_LIMBS}) limbs")


def rcb_fixed_base(rg, X, Y, scalars):
    """Projective [s_i] base for each row s_i of the canonical scalar limbs
    (n, 16) int32, from the window tables X, Y (32, 256, *coord_shape) of
    affine rows X[w][d] = d 2^(8w) base (row 0, the identity, is never
    read): K6's fixed-base kernel on CUDA, plain on CPU. The same bits as
    the per-window loop acc = madd(acc, (X[w][d], Y[w][d], d == 0)) from
    the identity. The tables are repacked once a call into packed words
    (8192 rows; no flag bit) for the kernel."""
    if scalars.device.type == "cpu":
        return rcb_fixed_base_plain(rg, X, Y, scalars)
    check_fixed_base(rg.cf, X, Y, scalars)
    for name, t in (("X", X), ("Y", Y), ("scalars", scalars)):
        cuda_build.check_tensor(t, f"rcb_fixed_base {name}")
    n = scalars.shape[0]
    xw, yw = (pack_limbs(t.reshape(FB_WINDOWS * FB_ROWS, -1)) for t in (X, Y))
    out = [torch.empty((n, *rg.cf.coord_shape), dtype=torch.int32, device=scalars.device)
           for _ in range(3)]
    if n == 0:
        return tuple(out)
    rc = cuda_build.lib().zkp_rcb_fixed_base(
        rg.kconsts.ctypes.data, rg.cf.ext, *_launch_args(out), xw.data_ptr(),
        yw.data_ptr(), scalars.data_ptr(), n, cuda_build.stream_ptr(out[0]))
    cuda_build.count("rcb_fixed_base", rg.kconsts)
    cuda_build.check(rc, "rcb_fixed_base")
    return tuple(out)


def rcb_fixed_base_plain(rg, X, Y, scalars):
    """Plain K6 fixed-base: the window loop with torch indexing, each step
    Alg. 8 and the flag select over the plain field (`madd_formula`)."""
    check_fixed_base(rg.cf, X, Y, scalars)
    rgp = rg.plain
    sc = scalars.to(torch.int64)
    acc = rgp.identity((sc.shape[0],))
    for w in range(FB_WINDOWS):
        d = (sc[:, w // 2] >> (8 * (w % 2))) & (FB_ROWS - 1)
        acc = rgp.madd_formula(acc, (X[w][d], Y[w][d], d == 0))
    return acc


# ------------------------------------------------------------ K2 / K3 / K4
def pack_limbs_flag(rg, X, Y, inf):
    """(Xp, Yp) packed words (n, R/2), the infinity flag in bit 31 of Xp's
    top word. Needs top-limb headroom (p < 2^(16 L - 1)), asserted.
    Reference: `pallas_rcb.pack_limbs_flag` (`ops/pallas_rcb.py:640`)."""
    df = rg.df
    assert df.spec.modulus >> (16 * df.L - 1) == 0, "no flag headroom"
    n = X.shape[0]
    xp = pack_limbs(X.reshape(n, -1))
    xp[:, -1] = torch.where(inf, xp[:, -1] | torch.iinfo(torch.int32).min, xp[:, -1])
    return xp, pack_limbs(Y.reshape(n, -1))


def unpack_coord(rg, words):
    """(M, R/2) packed words -> (M, *coord_shape) int32 limbs."""
    return unpack_words(words).to(torch.int32).reshape(words.shape[0], *rg.cf.coord_shape)


def unpack_leaves(rg, xw, yw):
    """Packed words with flag -> (X, Y, inf) standard int32 coordinates."""
    inf = xw[:, -1] < 0  # bit 31 of the top X word
    X = unpack_coord(rg, xw)
    X.reshape(X.shape[0], -1)[:, -1] &= MASK >> 1  # clear the flag bit from the top limb
    return X, unpack_coord(rg, yw), inf


def _scan_launch(rg, mode: int, ins, M: int, B: int, with_w: bool, aux=None):
    """Launch mode `mode` of `zkp_rcb_scan`; aux: the flags (M,) bool of
    modes 3 and 4, or the order (M,) int64 of mode 0 (None: none)."""
    cs = rg.cf.coord_shape
    dev = ins[0].device
    G = M // B
    for i, t in enumerate(ins):
        cuda_build.check_tensor(t, f"rcb_scan input {i}")
    if aux is not None:
        cuda_build.check_tensor(aux, "rcb_scan order" if mode == 0 else "rcb_scan flags",
                                (M,), torch.int64 if mode == 0 else torch.bool)
    W = [torch.empty((M, *cs), dtype=torch.int32, device=dev) for _ in range(3)] \
        if with_w else [None] * 3
    T = [torch.empty((G, *cs), dtype=torch.int32, device=dev) for _ in range(3)]
    z = ins[2] if len(ins) == 3 else None
    rc = cuda_build.lib().zkp_rcb_scan(
        rg.kconsts.ctypes.data, rg.cf.ext, mode, *_launch_args(W),
        *_launch_args(T), ins[0].data_ptr(), ins[1].data_ptr(),
        None if z is None else z.data_ptr(),
        None if aux is None else aux.data_ptr(), G, B,
        cuda_build.stream_ptr(T[0]),
    )
    return rc, (tuple(W) if with_w else None), tuple(T)


def team_shape(rg, n: int) -> tuple[int, int]:
    """(lanes of a team, threads per block) of the K2-K5 team kernels for
    n chains (K2-K4) or points (K5), as their C launchers pick them (for
    reports; needs the card)."""
    L = cuda_build.lib()
    return L.zkp_rcb_team_lanes(rg.cf.ext, n), L.zkp_rcb_team_block(rg.cf.ext, n)


def _check_blocks(M: int, B: int):
    if B <= 0 or M % B:
        raise ValueError(f"scan: {M} elements are not a multiple of B = {B}")


def scan_prefix_madd(rg, xw, yw, B: int, order=None):
    """K2: packed affine leaves xw, yw (n, R/2) read through `order` (M,)
    int64 (leaf e of the scan is row order[e]; None: the rows in order,
    M = n), M = G*B -> (W (M,), T (G,)). The kernel reads rows as it is
    told: every order entry must lie in [0, n)."""
    M = xw.shape[0] if order is None else order.shape[0]
    _check_blocks(M, B)
    if xw.device.type == "cpu":
        return scan_prefix_madd_plain(rg, xw, yw, B, order)
    rc, W, T = _scan_launch(rg, 0, (xw.contiguous(), yw.contiguous()), M, B, True,
                            None if order is None else order.contiguous())
    cuda_build.count("scan_prefix_madd", rg.kconsts)
    if order is not None:
        cuda_build.ORDERED["scan_prefix_madd"] += 1
    cuda_build.check(rc, "scan_prefix_madd")
    return W, T


def scan_prefix_madd_unpacked(rg, X, Y, inf, B: int):
    """K2a: sorted affine leaves as limb rows X, Y (M = G*B, *coord_shape)
    with the flags inf (M,) bool -> (W (M,), T (G,))."""
    M = X.shape[0]
    _check_blocks(M, B)
    if X.device.type == "cpu":
        return scan_prefix_madd_unpacked_plain(rg, X, Y, inf, B)
    rc, W, T = _scan_launch(rg, 3, (X.contiguous(), Y.contiguous()), M, B, True,
                            inf.contiguous())
    cuda_build.COUNTS["scan_prefix_madd_unpacked"] += 1
    cuda_build.check(rc, "scan_prefix_madd_unpacked")
    return W, T


def scan_prefix_madd_packed(rg, xw, yw, inf, B: int):
    """K2b: sorted affine leaves as packed words xw, yw (M, R/2) (`pack_limbs`,
    no flag bit) with the flags inf (M,) bool -> (W (M,), T (G,))."""
    M = xw.shape[0]
    _check_blocks(M, B)
    if xw.device.type == "cpu":
        return scan_prefix_madd_packed_plain(rg, xw, yw, inf, B)
    rc, W, T = _scan_launch(rg, 4, (xw.contiguous(), yw.contiguous()), M, B, True,
                            inf.contiguous())
    cuda_build.COUNTS["scan_prefix_madd_packed"] += 1
    cuda_build.check(rc, "scan_prefix_madd_packed")
    return W, T


def scan_prefix_add(rg, pts, B: int):
    """K3: projective points (M = G*B) -> (W (M,), T (G,))."""
    M = pts[0].shape[0]
    _check_blocks(M, B)
    if pts[0].device.type == "cpu":
        return scan_prefix_add_plain(rg, pts, B)
    rc, W, T = _scan_launch(rg, 1, [c.contiguous() for c in pts], M, B, True)
    cuda_build.count("scan_prefix_add", rg.kconsts)
    cuda_build.check(rc, "scan_prefix_add")
    return W, T


def scan_total_add(rg, pts, B: int):
    """K4: projective points (M = G*B) -> block totals T (G,)."""
    M = pts[0].shape[0]
    _check_blocks(M, B)
    if pts[0].device.type == "cpu":
        return scan_total_add_plain(rg, pts, B)
    rc, _, T = _scan_launch(rg, 2, [c.contiguous() for c in pts], M, B, False)
    cuda_build.count("scan_total_add", rg.kconsts)
    cuda_build.check(rc, "scan_total_add")
    return T


def _blocked(c, B):
    return c.reshape(c.shape[0] // B, B, *c.shape[1:])


def _scan_plain(rg, leaves, B: int, step, with_w: bool):
    G = leaves[0].shape[0] // B
    bl = [_blocked(c, B) for c in leaves]
    acc = rg.identity((G,))
    ws = []
    for b in range(B):
        acc = step(acc, tuple(c[:, b] for c in bl))
        if with_w:
            ws.append(acc)
    if not with_w:
        return None, acc
    W = tuple(
        torch.stack([w[k] for w in ws], dim=1).reshape(G * B, *acc[k].shape[1:])
        for k in range(3)
    )
    return W, acc


def scan_prefix_madd_plain(rg, xw, yw, B: int, order=None):
    """Plain K2: the leaves gathered through `order`, then the scan."""
    if order is not None:
        xw, yw = xw[order], yw[order]
    rgp = rg.plain
    return _scan_plain(rgp, unpack_leaves(rg, xw, yw), B, rgp.madd, True)


def scan_prefix_madd_unpacked_plain(rg, X, Y, inf, B: int):
    rgp = rg.plain
    return _scan_plain(rgp, (X, Y, inf), B, rgp.madd, True)


def scan_prefix_madd_packed_plain(rg, xw, yw, inf, B: int):
    return scan_prefix_madd_unpacked_plain(
        rg, unpack_coord(rg, xw), unpack_coord(rg, yw), inf, B)


def scan_prefix_add_plain(rg, pts, B: int):
    rgp = rg.plain
    return _scan_plain(rgp, tuple(pts), B, rgp.add_formula, True)


def scan_total_add_plain(rg, pts, B: int):
    rgp = rg.plain
    return _scan_plain(rgp, tuple(pts), B, rgp.add_formula, False)[1]

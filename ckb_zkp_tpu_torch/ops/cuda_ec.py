"""K8 (the Jacobian add, elementwise and as a chain), K9a (the Jacobian
mixed add, elementwise and as the fixed-base MSM) and K9b/K9c (Jacobian
block totals): wrappers, plain versions and launch counters of the
Jacobian MSM engine.

They replace the four kernels of the reference's `ops/pallas_ec.py`:
K8 `_ec_add_kernel` (`:247`, entry `ec_add_pallas`), K9a `_ec_madd_kernel`
(`:259`, `ec_madd_pallas`), K9b `_scan_madd_kernel` (`:271`,
`ec_block_totals_madd`) and K9c `_scan_add_kernel` (`:290`,
`ec_block_totals_add`). On Hopper (`csrc/ec_jac.cuh`, `ec_team.cuh`,
`ec_add.cu`, `ec_madd.cu`, `ec_fixed_base.cu`, `ec_scan.cu`):
K8 runs one add on a team of lanes, one product of a level of the
formula a lane (4 lanes for G1; for G2 16, each Fq2 product on three, up
to EC_SPLIT_MAX points), and its chain entry runs a point's doublings and adds in
one launch (the MSM's window folds); the setup's fixed-base MSM runs K9a
as one chain of 32 mixed adds a point, reading the window-table rows
through the scalar's digits, one thread a point; the elementwise K9a and
K9b/K9c run one thread per element or block of B elements, from infinity
(one, one, 0), as the TPU kernels do. All run the reference's formulas
(`_add_core`, `_madd_core`, `_double_core`) over 32-bit words and are
bound by the integer multiply rate.

Layouts: points are tuples (X, Y, Z) of (M, L) or (M, 2, L) int32 limb
tensors; affine leaves are (X, Y, inf) with a bool flag of the batch
shape. A CUDA tensor launches the kernel or raises; CPU tensors take the
plain version, which is the same formula as torch ops over the plain
field (`ops/ec.py`).
"""

from __future__ import annotations

import torch

from . import cuda_build
from .cuda_rcb import (FB_ROWS, FB_WINDOWS, _check_blocks, _launch_args,
                       check_fixed_base, launch_mixed, launch_pairwise)
from .ec import ec_add_formula, ec_madd_formula, point_infinity, point_select
from .limbs import pack_limbs


def _kconsts(cf):
    """The C entries' constant block: p, R mod p and -p^-1 of the base
    field (the Jacobian formulas use no curve constant)."""
    return (cf.df if cf.ext == 2 else cf).kconsts


# ------------------------------------------------------------------ K8
EC_SPLIT_MAX = 2048  # G2 points up to which a team has 16 lanes (kEcSplitMax)


def ec_add(cf, p, q, thread: bool = False):
    """Elementwise complete Jacobian p + q: K8 on CUDA, plain on CPU.
    `thread`: one thread a point instead of the team (the per-shape
    checks' yardstick)."""
    if p[0].device.type == "cpu":
        return ec_add_plain(cf, p, q)
    return launch_pairwise("zkp_ec_add", "ec_add", _kconsts(cf), cf, p, q, int(thread))


def ec_add_plain(cf, p, q):
    """Plain K8: the `ec_add` formula over the plain field."""
    return ec_add_formula(cf.plain, p, q)


def ec_team_lanes(cf, n: int) -> int:
    """Lanes a point of K8's team for a launch of n points, as
    `csrc/ec_team.cuh` picks them: 16 for G2 up to EC_SPLIT_MAX points
    (each Fq2 product split over three), else 4."""
    return 16 if cf.ext == 2 and n <= EC_SPLIT_MAX else 4


CHAIN_MAX = 64  # rounds of one chain launch (csrc/ec_team.cuh kChainMax)


def _check_chain(cf, init, addends, dbl):
    k = init[0].shape[0]
    shape = (len(dbl), k, *cf.coord_shape)
    if not 0 < len(dbl) <= CHAIN_MAX or any(not 0 <= d < 256 for d in dbl):
        raise ValueError(f"ec_add_chain: {len(dbl)} rounds of {list(dbl)} doublings "
                         f"(1 to {CHAIN_MAX} rounds of 0 to 255)")
    for i, c in enumerate((*init, *addends)):
        want = shape[1:] if i < 3 else shape
        if tuple(c.shape) != want:
            raise ValueError(f"ec_add_chain: operand {i} {tuple(c.shape)} != {want}")


def ec_add_chain(cf, init, addends, dbl):
    """K8's chain: for each of k points, acc = init[i], then for each round
    r dbl[r] doublings acc = acc + acc and acc = acc + addends[r, i], with
    the complete add; init (k,) points, addends (R, k) points, dbl R ints.
    One launch on CUDA, plain on CPU. The same bits as the loop of K8
    launches it replaces (`ec_add_chain_plain`)."""
    if init[0].device.type == "cpu":
        return ec_add_chain_plain(cf, init, addends, dbl)
    _check_chain(cf, init, addends, dbl)
    ins = [c.contiguous() for c in (*init, *addends)]
    for i, c in enumerate(ins):
        cuda_build.check_tensor(c, f"ec_add_chain operand {i}")
    k = ins[0].shape[0]
    out = [torch.empty_like(ins[0]) for _ in range(3)]
    steps = bytes(dbl)
    rc = cuda_build.lib().zkp_ec_add_chain(
        _kconsts(cf).ctypes.data, cf.ext, *_launch_args(out), *_launch_args(ins),
        steps, len(steps), k, cuda_build.stream_ptr(out[0]))
    cuda_build.COUNTS["ec_add_chain"] += 1
    cuda_build.check(rc, "ec_add_chain")
    return tuple(out)


def ec_add_chain_plain(cf, init, addends, dbl):
    """Plain K8 chain: the loop of plain adds, t + t for a doubling."""
    _check_chain(cf, init, addends, dbl)
    acc = tuple(init)
    for r, d in enumerate(dbl):
        for _ in range(d):
            acc = ec_add_plain(cf, acc, acc)
        acc = ec_add_plain(cf, acc, tuple(a[r] for a in addends))
    return acc


# ------------------------------------------------------------------ K9a
def ec_madd(cf, p, q_affine):
    """Elementwise Jacobian p + affine (x2, y2, inf): K9a on CUDA, plain
    on CPU. Operands broadcast as in `ec_madd_pallas`; inf has the batch
    shape only."""
    if p[0].device.type == "cpu":
        return ec_madd_plain(cf, p, q_affine)
    return launch_mixed("zkp_ec_madd", "ec_madd", _kconsts(cf), cf, p, q_affine)


def ec_madd_plain(cf, p, q_affine):
    """Plain K9a: `_madd_core` as torch ops over the plain field."""
    return ec_madd_formula(cf.plain, p, q_affine)


# ------------------------------------------------- K9a, the fixed-base MSM
def ec_fixed_base(cf, X, Y, scalars):
    """Jacobian [s_i] base for each row s_i of the canonical scalar limbs
    (n, 16) int32, from the window tables X, Y (32, 256, *coord_shape) of
    affine rows X[w][d] = d 2^(8w) base: K9a's fixed-base kernel on CUDA,
    plain on CPU. Each point's 32 windows are one chain of mixed adds from
    infinity (one, one, 0) that skips a zero digit (row 0 is never read).
    After normalization, the same points as the per-window loop acc =
    ec_madd(acc, (X[w][d], Y[w][d], d == 0)) (before it, an all-zero
    scalar gives another representative of infinity). The tables are
    repacked once a call into packed words for the kernel."""
    if scalars.device.type == "cpu":
        return ec_fixed_base_plain(cf, X, Y, scalars)
    check_fixed_base(cf, X, Y, scalars, "ec_fixed_base")
    for name, t in (("X", X), ("Y", Y), ("scalars", scalars)):
        cuda_build.check_tensor(t, f"ec_fixed_base {name}")
    n = scalars.shape[0]
    xw, yw = (pack_limbs(t.reshape(FB_WINDOWS * FB_ROWS, -1)) for t in (X, Y))
    out = [torch.empty((n, *cf.coord_shape), dtype=torch.int32, device=scalars.device)
           for _ in range(3)]
    if n == 0:
        return tuple(out)
    rc = cuda_build.lib().zkp_ec_fixed_base(
        _kconsts(cf).ctypes.data, cf.ext, *_launch_args(out), xw.data_ptr(),
        yw.data_ptr(), scalars.data_ptr(), n, cuda_build.stream_ptr(out[0]))
    cuda_build.COUNTS["ec_fixed_base"] += 1
    cuda_build.check(rc, "ec_fixed_base")
    return tuple(out)


def ec_fixed_base_plain(cf, X, Y, scalars):
    """Plain K9a fixed-base: the window loop with torch indexing, each
    step the mixed add over the plain field where the digit is not zero
    (the accumulator kept where it is), as the kernel skips."""
    check_fixed_base(cf, X, Y, scalars, "ec_fixed_base")
    pf = cf.plain
    sc = scalars.to(torch.int64)
    acc = point_infinity(pf, (sc.shape[0],))
    for w in range(FB_WINDOWS):
        d = (sc[:, w // 2] >> (8 * (w % 2))) & (FB_ROWS - 1)
        live = d != 0
        step = ec_madd_formula(pf, acc, (X[w][d], Y[w][d], torch.zeros_like(live)))
        acc = point_select(pf, live, step, acc)
    return acc


# ------------------------------------------------------------ K9b / K9c
def _totals_launch(cf, mode: int, ins, M: int, B: int, count: str):
    G = M // B
    dev = ins[0].device
    for i, t in enumerate(ins[:2]):
        cuda_build.check_tensor(t, f"{count} input {i}")
    if mode == 0:
        cuda_build.check_tensor(ins[2], f"{count} flags", (M,), torch.bool)
    else:
        cuda_build.check_tensor(ins[2], f"{count} input 2")
    T = [torch.empty((G, *cf.coord_shape), dtype=torch.int32, device=dev)
         for _ in range(3)]
    rc = cuda_build.lib().zkp_ec_scan(
        _kconsts(cf).ctypes.data, cf.ext, mode, *(t.data_ptr() for t in T),
        *(t.data_ptr() for t in ins), G, B, cuda_build.stream_ptr(T[0]))
    cuda_build.COUNTS[count] += 1
    cuda_build.check(rc, count)
    return tuple(T)


def block_totals_madd(cf, leaves, B: int):
    """K9b: sorted affine leaves (X, Y, inf), M = G*B of them -> (G,)
    Jacobian block totals, each the sum of its B leaves from infinity."""
    M = leaves[0].shape[0]
    _check_blocks(M, B)
    if leaves[0].device.type == "cpu":
        return block_totals_madd_plain(cf, leaves, B)
    ins = [c.contiguous() for c in leaves]
    return _totals_launch(cf, 0, ins, M, B, "ec_block_totals_madd")


def block_totals_add(cf, pts, B: int):
    """K9c: Jacobian points (M = G*B) -> (G,) block totals."""
    M = pts[0].shape[0]
    _check_blocks(M, B)
    if pts[0].device.type == "cpu":
        return block_totals_add_plain(cf, pts, B)
    ins = [c.contiguous() for c in pts]
    return _totals_launch(cf, 1, ins, M, B, "ec_block_totals_add")


def _totals_plain(cf, elems, B: int, step):
    G = elems[0].shape[0] // B
    blocked = [c.reshape(G, B, *c.shape[1:]) for c in elems]
    acc = point_infinity(cf, (G,))
    for b in range(B):
        acc = step(cf, acc, tuple(c[:, b] for c in blocked))
    return acc


def block_totals_madd_plain(cf, leaves, B: int):
    """Plain K9b: a loop of B plain mixed adds."""
    return _totals_plain(cf.plain, leaves, B, ec_madd_formula)


def block_totals_add_plain(cf, pts, B: int):
    """Plain K9c: a loop of B plain adds."""
    return _totals_plain(cf.plain, pts, B, ec_add_formula)

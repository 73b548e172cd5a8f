"""K8 (elementwise Jacobian add), K9a (elementwise Jacobian mixed add) and
K9b/K9c (Jacobian block totals): wrappers, plain versions and launch
counters of the Jacobian MSM engine.

They replace the four kernels of the reference's `ops/pallas_ec.py`:
K8 `_ec_add_kernel` (`:247`, entry `ec_add_pallas`), K9a `_ec_madd_kernel`
(`:259`, `ec_madd_pallas`), K9b `_scan_madd_kernel` (`:271`,
`ec_block_totals_madd`) and K9c `_scan_add_kernel` (`:290`,
`ec_block_totals_add`). On Hopper (`csrc/ec_jac.cuh`, `ec_add.cu`,
`ec_madd.cu`, `ec_scan.cu`) K8 and K9a run one thread per element; K9b and
K9c run one thread per block of B elements, from infinity (one, one, 0),
and write only the block totals, as the TPU kernels do. All four run the
reference's formulas (`_add_core`, `_madd_core`, `_double_core`) over
32-bit words and are bound by the integer multiply rate.

Layouts: points are tuples (X, Y, Z) of (M, L) or (M, 2, L) int32 limb
tensors; affine leaves are (X, Y, inf) with a bool flag of the batch
shape. A CUDA tensor launches the kernel or raises; CPU tensors take the
plain version, which is the same formula as torch ops over the plain
field (`ops/ec.py`).
"""

from __future__ import annotations

import torch

from . import cuda_build
from .cuda_rcb import _check_blocks, launch_mixed, launch_pairwise
from .ec import ec_add_formula, ec_madd_formula, point_infinity


def _kconsts(cf):
    """The C entries' constant block: p, R mod p and -p^-1 of the base
    field (the Jacobian formulas use no curve constant)."""
    return (cf.df if cf.ext == 2 else cf).kconsts


# ------------------------------------------------------------------ K8
def ec_add(cf, p, q):
    """Elementwise complete Jacobian p + q: K8 on CUDA, plain on CPU."""
    if p[0].device.type == "cpu":
        return ec_add_plain(cf, p, q)
    return launch_pairwise("zkp_ec_add", "ec_add", _kconsts(cf), cf, p, q)


def ec_add_plain(cf, p, q):
    """Plain K8: the `ec_add` formula over the plain field."""
    return ec_add_formula(cf.plain, p, q)


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

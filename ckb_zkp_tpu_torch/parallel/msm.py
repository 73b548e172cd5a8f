"""Sharded Pippenger MSM: a row block of points and scalars per rank, the
partial sums folded across the ranks.

Port of the reference's `parallel/msm.py` (`:1-78`): each rank runs the
whole windowed Pippenger on its block (the port's `DeviceCurveGroup.msm`:
the RCB engine, K1-K5, on the pairing groups, or the Jacobian one where a
caller set it; the reference runs its Jacobian `_msm_impl`, and both give
the same group element), then the partials are all-gathered and summed.
N/d work a rank, one small collective at the end.

Two departures, both about correctness:
- the reference pads points and scalars by a count taken from the
  scalars (`parallel/msm.py:66`), so a point list wider than its scalars
  (the prover's pow2-padded G2 query) pairs rank i's points with another
  block of scalars; here the scalars are first zero-extended to the
  points' length (as `DeviceCurveGroup.msm` does), then both are cut into
  blocks by one rule, the last blocks padded with identity points and zero
  scalars (`shard_put`);
- the fold runs where the group's width has a kernel: the Jacobian add
  (`p_add`, K8) has 8-word instances only, so a 12-word group (BLS12-381)
  folds with the RCB add (K5's 12-word instance) in projective
  coordinates.
"""

from __future__ import annotations

import torch

from ..ops.ec import muls, point_select
from ..ops.msm import DeviceCurveGroup
from .mesh import Mesh, all_gather_cat
from .multihost import shard_put

_JACOBIAN_WORDS = 8  # the Jacobian kernels' one width (K8, K9a-K9c)


def msm_sharded(dg: DeviceCurveGroup, points, scalars, mesh: Mesh):
    """points: the whole affine-encoded (X, Y, Z) list, as every rank holds
    it; scalars (N, L) canonical, N <= the points' length. Returns the same
    Jacobian point on every rank."""
    P, scalars = dg._msm_operands(tuple(points), scalars)
    P = shard_put(P, mesh, tuple(c[0] for c in dg.p_identity((1,))))
    part = dg.msm(P, shard_put(scalars, mesh, scalars.new_zeros(scalars.shape[1:])))
    shapes = [c.shape for c in part]
    flat = all_gather_cat(torch.cat([c.reshape(1, -1) for c in part], dim=1), mesh)
    gathered, col = [], 0
    for s in shapes:
        w = s.numel()
        gathered.append(flat[:, col : col + w].reshape(mesh.size, *s))
        col += w
    return fold(dg, tuple(gathered))


def fold(dg: DeviceCurveGroup, pts):
    """The sum of (d, ...) Jacobian points, by a halving tree of adds."""
    rcb = dg._affine_leaves and dg.fq.L // 2 > _JACOBIAN_WORDS
    if rcb:
        cf = dg.cf
        X, Y, Z = pts
        xz, z3 = muls(cf, [(X, Z), (Z, cf.mul(Z, Z))])
        # Jacobian (X, Y, Z) is projective (XZ : Y : Z^3); infinity (Z = 0) is (0 : 1 : 0)
        pts = point_select(cf, cf.is_zero(Z), dg.rg.identity(Z.shape[:1]), (xz, Y, z3))
        add = dg.rg.add
    else:
        add = dg.p_add
    n = pts[0].shape[0]
    while n > 1:
        h = n // 2
        s = add(tuple(c[:h] for c in pts), tuple(c[h : 2 * h] for c in pts))
        pts = tuple(torch.cat([a, c[2 * h :]]) for a, c in zip(s, pts))
        n = pts[0].shape[0]
    out = tuple(c[0] for c in pts)
    return dg.rg.to_jacobian(out) if rcb else out

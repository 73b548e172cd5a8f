"""Complete projective short-Weierstrass point ops (Renes-Costello-Batina).

Port of the reference's `ops/rcb.py` `RcbGroup` (`:44-201`): Algorithms 7
(add), 8 (mixed add) and 9 (double) of eprint 2015/1060 for a = 0, on
homogeneous projective (X : Y : Z) with the identity (0 : 1 : 0). The
formulas are the reference's step for step, so equal inputs give
bit-equal projective outputs; independent field multiplies of one step run
as one stacked batch (one K1 launch on the card), which changes no value.

On CUDA tensors `add` is K5 (`cuda_rcb.rcb_add`) and `madd` is K6
(`cuda_rcb.rcb_madd`) at every batch size; `double` and `neg` stay torch
compositions over the port's field, as they were XLA in the reference.
"""

from __future__ import annotations

import functools

import torch

from .cuda_field import kernel_consts
from .cuda_rcb import rcb_add, rcb_madd
from .ec import DeviceFq2, adds, addsubs, muls, point_select
from .field import DeviceField


def b3_add_chain(b3: tuple, ext: int, most: int) -> tuple[int, bool]:
    """(k, twist) when the kernels can multiply by 3b = (b3[0], b3[1]) with
    an add chain of k <= most: 3b = k over Fq or Fq2 (twist False; over Fq2
    only where b3[1] = 0), or 3b = k + k u over Fq2 (twist True, the
    BLS12-381 G2 twist: 3 * 4(1 + u)); else (0, False) and the kernels
    multiply by the Montgomery-form constant (BN254's G2: 3 * 3 / (9 + u))."""
    k = b3[0]
    if not 0 < k <= most:
        return 0, False
    if b3[1] == 0:
        return k, False
    return (k, True) if ext == 2 and b3[1] == k else (0, False)


class RcbGroup:
    """RCB complete-formula ops over a coordinate field (Fq or Fq2).

    `b` is the curve constant (int for G1, (c0, c1) ints for G2 twists)."""

    SMALL_B3_MAX = 1 << 10

    def __init__(self, cf, b):
        self.cf = cf
        self.b = b
        self.df = df = cf.df if isinstance(cf, DeviceFq2) else cf
        assert isinstance(df, DeviceField)
        p = df.spec.modulus
        b3 = (3 * b[0] % p, 3 * b[1] % p) if isinstance(cf, DeviceFq2) else (
            3 * b % p, 0)
        # the kernels multiply by 3b = k or k + k u (a small k) with an add
        # chain; the torch compositions multiply by the constant (the same
        # canonical value)
        small, twist = b3_add_chain(b3, cf.ext, self.SMALL_B3_MAX)
        self.b3_twist = twist  # the kernels' 3b products over Fq2 are add chains
        self.b3_const = df.encode(list(b3[: cf.ext])).reshape(cf.coord_shape)
        self.kconsts = kernel_consts(df, small, [x * df.R % p for x in b3], twist)

    @functools.cached_property
    def plain(self) -> "RcbGroup":
        return self if self.cf.is_plain else RcbGroup(self.cf.plain, self.b)

    # ---- identity (0 : 1 : 0) ----
    def identity(self, batch_shape=()):
        cf = self.cf
        return (cf.zeros(batch_shape), cf.ones(batch_shape), cf.zeros(batch_shape))

    def neg(self, p):
        return (p[0], self.cf.neg(p[1]), p[2])

    def mul_b3(self, t):
        return self.cf.mul(t, self.b3_const)

    # ---- Algorithm 7: complete projective add, a = 0 ----
    def add(self, p, q):
        if self.cf.is_plain:
            return self.add_formula(p, q)
        return rcb_add(self, p, q)

    def add_formula(self, p, q):
        """Alg. 7 as torch ops (K5's plain version)."""
        cf = self.cf
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        s = adds(cf, [(X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1), (X2, Z2)])
        t0, t1, t2, t3, t4, X3 = muls(
            cf, [(X1, X2), (Y1, Y2), (Z1, Z2), (s[0], s[1]), (s[2], s[3]),
                 (s[4], s[5])]
        )
        u = adds(cf, [(t0, t1), (t1, t2), (t0, t2), (t0, t0)])
        t3, t4, Y3, t0 = addsubs(  # X1Y2 + X2Y1, Y1Z2 + Y2Z1, X1Z2 + X2Z1, 3 X1X2
            cf, [(t3, u[0]), (t4, u[1]), (X3, u[2]), (u[3], t0)],
            (True, True, True, False))
        t2, Y3 = self.mul_b3(torch.stack(torch.broadcast_tensors(t2, Y3))).unbind(0)
        Z3, t1 = addsubs(cf, [(t1, t2), (t1, t2)], (False, True))
        m = muls(cf, [(t3, t1), (t4, Y3), (t1, Z3), (Y3, t0), (Z3, t4), (t0, t3)])
        return tuple(addsubs(
            cf, [(m[0], m[1]), (m[2], m[3]), (m[4], m[5])], (True, False, False)))

    # ---- Algorithm 8: mixed add (Q affine, Z2 = 1), a = 0 ----
    def madd_noinf(self, p, xy2):
        """p + (x2, y2, 1); q must NOT be the identity."""
        cf = self.cf
        X1, Y1, Z1 = p
        X2, Y2 = xy2
        s = adds(cf, [(X2, Y2), (X1, Y1)])
        t0, t1, t3, a, b = muls(
            cf, [(X1, X2), (Y1, Y2), (s[0], s[1]), (X2, Z1), (Y2, Z1)]
        )
        u = adds(cf, [(t0, t1), (a, X1), (b, Y1), (t0, t0)])
        t4, t5 = u[1], u[2]
        t3, t0 = addsubs(cf, [(t3, u[0]), (u[3], t0)], (True, False))
        t2, Y3 = self.mul_b3(torch.stack(torch.broadcast_tensors(Z1, t4))).unbind(0)
        Z3, t1 = addsubs(cf, [(t1, t2), (t1, t2)], (False, True))
        m = muls(cf, [(t3, t1), (t5, Y3), (t1, Z3), (Y3, t0), (Z3, t5), (t0, t3)])
        return tuple(addsubs(
            cf, [(m[0], m[1]), (m[2], m[3]), (m[4], m[5])], (True, False, False)))

    def madd(self, p, q_affine):
        """p + Q where Q = (x2, y2, inf_mask) may be the identity."""
        if self.cf.is_plain:
            return self.madd_formula(p, q_affine)
        return rcb_madd(self, p, q_affine)

    def madd_formula(self, p, q_affine):
        """Alg. 8 and the flag select as torch ops (K6's plain version)."""
        x2, y2, inf2 = q_affine
        out = self.madd_noinf(p, (x2, y2))
        return point_select(self.cf, inf2, p, out)

    # ---- Algorithm 9: doubling, a = 0 ----
    def double(self, p):
        cf = self.cf
        X, Y, Z = p
        t0, t1, zz, xy = muls(cf, [(Y, Y), (Y, Z), (Z, Z), (X, Y)])
        Z3 = cf.add(t0, t0)
        Z3 = cf.add(Z3, Z3)
        Z3 = cf.add(Z3, Z3)  # 8 Y^2
        t2 = self.mul_b3(zz)  # 3b Z^2
        Y3, t2x2, xy2 = adds(cf, [(t0, t2), (t2, t2), (xy, xy)])
        t0 = cf.sub(t0, cf.add(t2x2, t2))  # Y^2 - 9b Z^2
        X3, Z3, m, X3f = muls(cf, [(t2, Z3), (t1, Z3), (t0, Y3), (xy2, t0)])
        return (X3f, cf.add(X3, m), Z3)

    # ---- conversions ----
    def from_affine_enc(self, P):
        """Affine-encoded Jacobian (Z in {0, one}) -> projective; infinity
        (Z = 0) maps to (0 : 1 : 0)."""
        X, Y, Z = P
        inf = self.cf.is_zero(Z)
        return point_select(self.cf, inf, self.identity(inf.shape), (X, Y, Z))

    def to_jacobian(self, p):
        """Projective -> Jacobian with the same affine value: (XZ, YZ^2, Z)."""
        cf = self.cf
        X, Y, Z = p
        z2, xz = muls(cf, [(Z, Z), (X, Z)])
        return (xz, cf.mul(Y, z2), Z)

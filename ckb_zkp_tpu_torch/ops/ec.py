"""Fq2, point selection and Jacobian point arithmetic on torch tensors.

Port of the reference's `ops/ec.py`: `DeviceFq2` (`:21-80`),
`point_select` (`:88`), and the Jacobian engine's point ops
`point_infinity` (`:92`), `is_infinity` (`:96`), `ec_double` (`:100-117`),
`ec_add` (`:139-169`), `ec_neg` (`:172`) and `to_affine` (`:188-195`).
Points are tuples (X, Y, Z) of ``(..., L)`` (Fq) or ``(..., 2, L)`` (Fq2)
int32 limb tensors; Jacobian points have Z == 0 at infinity.

The Jacobian formulas are for a = 0 curves only, as the reference's are
(its doubling has no a Z^4 term); `DeviceCurveGroup` refuses a group with
a != 0. `ec_add` is K8 on CUDA tensors (`cuda_ec.ec_add`); `ec_double`
stays torch, as it was XLA in the reference. Independent field multiplies
of one step run as one stacked batch, which changes no value.
"""

from __future__ import annotations

import functools

import torch

from .field import DeviceField


class DeviceFq2:
    """Fq2 = Fq[u]/(u^2 + 1); elements are (..., 2, L) limbs."""

    ext = 2

    def __init__(self, df: DeviceField):
        self.df = df
        self.L = df.L
        self.device = df.device
        self.is_plain = df.is_plain

    @functools.cached_property
    def plain(self) -> "DeviceFq2":
        return self if self.is_plain else DeviceFq2(self.df.plain)

    coord_shape = property(lambda self: (2, self.L))

    def zeros(self, batch_shape=()):
        return self.df.zeros((*batch_shape, 2))

    def ones(self, batch_shape=()):
        return torch.stack(
            [self.df.ones(batch_shape), self.df.zeros(batch_shape)], dim=-2
        )

    def add(self, a, b):
        return self.df.add(a, b)

    def sub(self, a, b):
        return self.df.sub(a, b)

    def addsub(self, a, b, neg):
        return self.df.addsub(a, b, neg)

    def neg(self, a):
        return self.df.neg(a)

    def mul(self, a, b):
        """Karatsuba, beta = -1: the three Fq products run as one batch."""
        df = self.df
        a, b = torch.broadcast_tensors(a, b)
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        s = df.add(torch.stack([a0, b0]), torch.stack([a1, b1]))
        v = df.mul(torch.stack([a0, a1, s[0]]), torch.stack([b0, b1, s[1]]))
        c0, v01 = df.addsub(v[:2], v[:2].flip(0), (True, False))  # v0 - v1, v1 + v0
        return torch.stack([c0, df.sub(v[2], v01)], dim=-2)

    def is_zero(self, a):
        return (a == 0).all(dim=-1).all(dim=-1)

    def inv(self, a):
        """Inverse via the norm a0^2 + a1^2 (Fermat in Fq); 0 maps to 0."""
        return self._inv_by_norm(a, self.df.inv)

    def batch_inv(self, a):
        """As `inv`, the norms inverted by the Montgomery trick along dim 0
        (reference `ops/ec.py:74-79`)."""
        return self._inv_by_norm(a, self.df.batch_inv)

    def _inv_by_norm(self, a, fq_inv):
        df = self.df
        sq = df.mul(a, a)  # (..., 2, L): a0^2, a1^2
        ninv = fq_inv(df.add(sq[..., 0, :], sq[..., 1, :]))
        prod = df.mul(a, ninv.unsqueeze(-2))
        return torch.stack([prod[..., 0, :], df.neg(prod[..., 1, :])], dim=-2)


def coord_dims(cf) -> int:
    """Trailing dims of one coordinate: 1 for Fq, 2 for Fq2."""
    return 2 if isinstance(cf, DeviceFq2) else 1


def _field_select(cf, mask, a, b):
    m = mask.reshape(mask.shape + (1,) * coord_dims(cf))
    return torch.where(m, a, b)


def point_select(cf, mask, p, q):
    return tuple(_field_select(cf, mask, a, b) for a, b in zip(p, q))


def stack_pairs(pairs):
    shapes = {t.shape for ab in pairs for t in ab}
    shape = shapes.pop() if len(shapes) == 1 else torch.broadcast_shapes(*shapes)
    A = torch.stack([a.expand(shape) for a, _ in pairs])
    B = torch.stack([b.expand(shape) for _, b in pairs])
    return A, B


def muls(cf, pairs):
    return cf.mul(*stack_pairs(pairs)).unbind(0)


def adds(cf, pairs):
    return cf.add(*stack_pairs(pairs)).unbind(0)


def addsubs(cf, pairs, neg):
    """a - b where neg, else a + b, for every pair, in one stacked call."""
    return cf.addsub(*stack_pairs(pairs), neg).unbind(0)


# ------------------------------------------------------- Jacobian, a = 0
def point_infinity(cf, batch_shape=()):
    return (cf.ones(batch_shape), cf.ones(batch_shape), cf.zeros(batch_shape))


def is_infinity(cf, p):
    return cf.is_zero(p[2])


def ec_neg(cf, p):
    return (p[0], cf.neg(p[1]), p[2])


def ec_double(cf, p):
    """Jacobian doubling, a = 0 (dbl-2009-l); infinity stays infinity."""
    X, Y, Z = p
    A, B, YZ = muls(cf, [(X, X), (Y, Y), (Y, Z)])
    XB = cf.add(X, B)
    C, XB2 = muls(cf, [(B, B), (XB, XB)])
    AC, A2 = adds(cf, [(A, C), (A, A)])
    t = cf.sub(XB2, AC)
    D, E, C2, Z3 = adds(cf, [(t, t), (A2, A), (C, C), (YZ, YZ)])  # D = 2((X+B)^2 - A - C)
    F = cf.mul(E, E)
    DD, C4 = adds(cf, [(D, D), (C2, C2)])
    X3, C8 = addsubs(cf, [(F, DD), (C4, C4)], (True, False))
    Y3 = cf.sub(cf.mul(E, cf.sub(D, X3)), C8)
    return (X3, Y3, Z3)


def _with_doubling(cf, H, r, p, general):
    """The doubling of p where H = r = 0 (p == q), else the general sum.
    The doubling is computed only if some element needs it: the same
    values as the reference's unconditional select."""
    both = cf.is_zero(H) & cf.is_zero(r)
    if not bool(both.any()):
        return general
    return point_select(cf, both, ec_double(cf, p), general)


def ec_add_formula(cf, p, q):
    """Complete Jacobian p + q as torch ops over `cf` (K8's plain version
    over the plain field): the general sum, the doubling of p where p == q,
    then q where p is infinity and p where q is (in the reference's order
    of selects). p == -q gives Z = 0 from the general sum. For q given as
    p itself (a doubling, t + t) that is the doubling of p, or p where it
    is infinity, and only that is computed."""
    if q is p:
        return point_select(cf, is_infinity(cf, p), p, ec_double(cf, p))
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1, Z2Z2, Z1Z2 = muls(cf, [(Z1, Z1), (Z2, Z2), (Z1, Z2)])
    U1, U2, Z2c, Z1c = muls(cf, [(X1, Z2Z2), (X2, Z1Z1), (Z2, Z2Z2), (Z1, Z1Z1)])
    S1, S2 = muls(cf, [(Y1, Z2c), (Y2, Z1c)])
    H, r = addsubs(cf, [(U2, U1), (S2, S1)], (True, True))
    HH, rr = muls(cf, [(H, H), (r, r)])
    HHH, V, Z3 = muls(cf, [(H, HH), (U1, HH), (Z1Z2, H)])
    X3 = cf.sub(cf.sub(rr, HHH), cf.add(V, V))
    rVX, S1H = muls(cf, [(r, cf.sub(V, X3)), (S1, HHH)])
    res = _with_doubling(cf, H, r, p, (X3, cf.sub(rVX, S1H), Z3))
    res = point_select(cf, is_infinity(cf, q), p, res)
    return point_select(cf, is_infinity(cf, p), q, res)


def ec_madd_formula(cf, p, q_affine):
    """Jacobian p + affine (x2, y2, inf) as torch ops over `cf` (K9a's
    plain version over the plain field; the reference's `_madd_core`,
    `ops/pallas_ec.py:204-239`). Equal to `ec_add_formula` with q promoted
    to Z in {0, one}: U1 = X1, S1 = Y1 and Z1 Z2 = Z1 exactly. Where p is
    infinity the result is (x2, y2, one), or (x2, y2, 0) for a flagged q."""
    X1, Y1, Z1 = p
    X2, Y2, qinf = q_affine
    Z1Z1 = cf.mul(Z1, Z1)
    U2, Z1c = muls(cf, [(X2, Z1Z1), (Z1, Z1Z1)])
    S2 = cf.mul(Y2, Z1c)
    H, r = addsubs(cf, [(U2, X1), (S2, Y1)], (True, True))
    HH, rr = muls(cf, [(H, H), (r, r)])
    HHH, V, Z3 = muls(cf, [(H, HH), (X1, HH), (Z1, H)])
    X3 = cf.sub(cf.sub(rr, HHH), cf.add(V, V))
    rVX, Y1H = muls(cf, [(r, cf.sub(V, X3)), (Y1, HHH)])
    res = _with_doubling(cf, H, r, p, (X3, cf.sub(rVX, Y1H), Z3))
    res = point_select(cf, qinf, p, res)
    z2 = point_select(cf, qinf, (cf.zeros(qinf.shape),), (cf.ones(qinf.shape),))[0]
    return point_select(cf, is_infinity(cf, p), (X2, Y2, z2), res)


def ec_add(cf, p, q):
    """Complete Jacobian addition: K8 on CUDA tensors, its plain version
    on CPU tensors (`cuda_ec.ec_add`; the reference dispatches to its
    Pallas kernel the same way, `ops/ec.py:143-146`)."""
    from .cuda_ec import ec_add as k8

    return k8(cf, p, q)


def to_affine(cf, p):
    """Jacobian -> affine (x, y, inf_mask); the Z inverses are one batch
    inversion along dim 0 (zeros stay zero)."""
    X, Y, Z = p
    zinv = cf.batch_inv(Z)
    zinv2 = cf.mul(zinv, zinv)
    x, zinv3 = muls(cf, [(X, zinv2), (zinv, zinv2)])
    return x, cf.mul(Y, zinv3), is_infinity(cf, p)

"""Fq2 and point selection helpers on torch tensors.

Port of the reference's `ops/ec.py`: `DeviceFq2` (`:21-80`) and
`point_select` (`:88`). Points are tuples (X, Y, Z) of
``(..., L)`` (Fq) or ``(..., 2, L)`` (Fq2) int32 limb tensors.
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

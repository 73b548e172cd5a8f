"""Prime-field arithmetic on torch tensors of 16-bit Montgomery limbs.

Port of the reference's `ops/field.py` `DeviceField` (`:41-313`). Elements
are ``(..., L)`` int32 tensors of canonical limbs (< p) in Montgomery form.
`mul`, `sqr`, `to_mont` and `from_mont` go through K1 (`cuda_field`) on
CUDA tensors at every batch size; add, sub and neg were XLA in the
reference and are plain torch (int64) here. A field built with
``plain=True`` runs every multiply through K1's plain version on any
device: the comparison phases use it to hold a kernel against its plain
version on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .cuda_field import mont_mul, mont_mul_plain
from .limbs import (
    BASE,
    BASE_BITS,
    MASK,
    int_to_limbs,
    ints_to_limbs,
    ks_resolve,
    limbs_to_ints,
    nlimbs_for,
    scalars,
    toeplitz_cols,
)
from .scan_utils import hs_scan


class DeviceField:
    """Batched Montgomery arithmetic over spec.modulus with 16-bit limbs."""

    ext = 1

    def __init__(self, spec, device="cuda", plain: bool = False):
        self.spec = spec
        self.device = torch.device(device)
        self.is_plain = plain
        p = spec.modulus
        self.L = L = nlimbs_for(spec.bits)
        assert spec.bits <= 16 * L - 1, "need headroom: 2p < R"
        self.R = (1 << (BASE_BITS * L)) % p
        self.R2 = self.R * self.R % p
        R_full = 1 << (BASE_BITS * L)
        self.nprime_limbs = int_to_limbs((-pow(p, -1, R_full)) % R_full, L)
        self.p_limbs = int_to_limbs(p, L)
        self.r_limbs = int_to_limbs(self.R, L)  # one in Montgomery form
        self.r2_limbs = int_to_limbs(self.R2, L)
        self.one_raw = int_to_limbs(1, L)
        comp = (MASK - self.p_limbs.astype(np.int64))
        comp[0] += 1  # ~p + 1; p is odd, so no limb overflow
        self._comp_p1 = comp
        from .cuda_field import kernel_consts

        self.kconsts = kernel_consts(self)
        self._c: dict = {}
        self._c32: dict = {}

    @functools.cached_property
    def plain(self) -> "DeviceField":
        return self if self.is_plain else DeviceField(self.spec, self.device, True)

    @property
    def coord_shape(self) -> tuple:
        return (self.L,)

    # ------------- constants on a device -------------
    def consts(self, device) -> dict:
        key = str(device)
        c = self._c.get(key)
        if c is None:
            t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)  # noqa: E731
            e0 = np.zeros(self.L, np.int64)
            e0[0] = 1
            c = self._c[key] = {
                "comp_p1": t(self._comp_p1),
                "p32": t(self.p_limbs).to(torch.int32),
                "comp32": t(self._comp_p1).to(torch.int32),
                "e032": t(e0).to(torch.int32),
                # the plain K1's float64 constants: m p, t n' mod R, the low
                # half's carry (limb k weighs 2^(16 (k - L)))
                "p_t": toeplitz_cols(self.p_limbs, device),
                "nprime_t": toeplitz_cols(self.nprime_limbs, device)[:, : self.L].contiguous(),
                "low_w": torch.tensor([2.0 ** (BASE_BITS * (k - self.L)) for k in range(self.L)],
                                      dtype=torch.float64, device=device),
                "carry_t": (torch.diag(torch.ones(self.L - 1, dtype=torch.float64), 1)
                            - BASE * torch.eye(self.L, dtype=torch.float64)).to(device),
            }
        return c

    def _const32(self, name: str) -> torch.Tensor:
        c = self._c32.get(name)
        if c is None:
            arr = getattr(self, name).astype(np.int32)
            c = self._c32[name] = torch.as_tensor(arr, device=self.device)
        return c

    def zeros(self, batch_shape=()) -> torch.Tensor:
        return torch.zeros(
            (*batch_shape, self.L), dtype=torch.int32, device=self.device
        )

    def ones(self, batch_shape=()) -> torch.Tensor:
        return self._const32("r_limbs").expand(*batch_shape, self.L).clone()

    def const(self, value: int, batch_shape=()) -> torch.Tensor:
        """Canonical int -> Montgomery-form constant."""
        v = value % self.spec.modulus * self.R % self.spec.modulus
        row = torch.as_tensor(
            int_to_limbs(v, self.L).astype(np.int32), device=self.device
        )
        return row.expand(*batch_shape, self.L).clone()

    # ------------- add/sub/neg (plain torch, int32: limbs stay < 2^18) -------
    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(a + b) mod p: a + b and a + b - p resolved in one carry pass."""
        return self._pick(a + b, self.consts(a.device)["comp32"], False)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(a - b) mod p via two's complement a + ~b + 1, and + p on borrow."""
        c = self.consts(a.device)
        return self._pick(a + (MASK - b) + c["e032"], c["p32"], True)

    def addsub(self, a: torch.Tensor, b: torch.Tensor, neg) -> torch.Tensor:
        """Stacked a[i] - b[i] where neg[i], else a[i] + b[i] (one pass for
        a batch of mixed adds and subs; neg indexes the leading dim)."""
        c = self.consts(a.device)
        n = torch.as_tensor(neg, device=a.device).reshape(-1, *[1] * (a.dim() - 1))
        t = torch.where(n, a + (MASK - b) + c["e032"], a + b)
        return self._pick(t, torch.where(n, c["p32"], c["comp32"]), n.squeeze(-1))

    @staticmethod
    def _pick(t: torch.Tensor, k: torch.Tensor, neg) -> torch.Tensor:
        """Resolve t and t + k (limbs <= 3 MASK + 1) in one stacked pass and
        return t + k where an add's t + k carries out (t >= p) or a sub's t
        does not (a borrow), else t; both mod R."""
        tk = t + k
        x = torch.stack((t, tk) if tk.shape == t.shape else torch.broadcast_tensors(t, tk))
        bits, mask, _ = scalars(x.device, x.dtype)
        hi = torch.bitwise_right_shift(x, bits)
        x = torch.bitwise_and(x, mask)
        x[..., 1:] += hi[..., :-1]  # limbs <= MASK + 2
        out, c = ks_resolve(x)
        carry = (c + hi[..., -1]).bool()
        if isinstance(neg, bool):
            use_k = carry[0].logical_not() if neg else carry[1]
        else:
            use_k = torch.where(neg, carry[0].logical_not(), carry[1])
        return torch.where(use_k.unsqueeze(-1), out[1], out[0])

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=-1)

    # ------------- multiplication (K1) -------------
    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product (a * b * R^-1) mod p."""
        if self.is_plain:
            return mont_mul_plain(self, a, b)
        return mont_mul(self, a, b)

    def sqr(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def pow_fixed(self, a: torch.Tensor, e: int) -> torch.Tensor:
        """a^e for a Python-int exponent (square and multiply)."""
        r = self.ones(a.shape[:-1])
        base = a
        while e:
            if e & 1:
                r = self.mul(r, base)
            e >>= 1
            if e:
                base = self.sqr(base)
        return r

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Fermat inversion; 0 maps to 0."""
        return self.pow_fixed(a, self.spec.modulus - 2)

    def batch_inv(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery-trick inversion along dim 0; zeros map to zeros
        (reference `ops/field.py:221-247`): a prefix and a suffix product
        by Hillis-Steele scans and one Fermat inversion of the total."""
        z = self.is_zero(a)
        x = torch.where(z.unsqueeze(-1), self.ones(a.shape[:-1]), a)
        mul = lambda u, v: (self.mul(u[0], v[0]),)  # noqa: E731
        prefix = hs_scan(mul, (x,))[0]
        suffix = hs_scan(mul, (x.flip(0),))[0].flip(0)
        total_inv = self.inv(prefix[-1:])
        one = self.ones((1, *a.shape[1:-1]))
        left = torch.cat([one, prefix[:-1]])
        right = torch.cat([suffix[1:], one])
        out = self.mul(self.mul(left, right), total_inv)
        return torch.where(z.unsqueeze(-1), torch.zeros_like(out), out)

    def powers(self, base: int, n: int) -> torch.Tensor:
        """[base^0 .. base^(n-1)] as (n, L) Montgomery limbs, by doubling
        (reference `ops/field.py:249-256`)."""
        table = self.ones((1,))
        b_pow = self.encode([base])
        while table.shape[0] < n:
            table = torch.cat([table, self.mul(table, b_pow)])
            b_pow = self.sqr(b_pow)
        return table[:n]

    # ------------- Montgomery conversion -------------
    def to_mont(self, raw: torch.Tensor) -> torch.Tensor:
        return self.mul(raw, self._const32("r2_limbs"))

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        # mont(a, 1) = a * R^-1: the same reduction, through K1
        return self.mul(a, self._const32("one_raw"))

    # ------------- host <-> device -------------
    def encode(self, ints) -> torch.Tensor:
        """Python ints -> (N, L) Montgomery-form limbs (converted on host)."""
        p = self.spec.modulus
        arr = ints_to_limbs([x % p * self.R % p for x in ints], self.L)
        return torch.as_tensor(arr.astype(np.int32), device=self.device)

    def decode(self, a: torch.Tensor) -> list[int]:
        """(..., L) Montgomery-form limbs -> canonical Python ints."""
        p = self.spec.modulus
        rinv = pow(self.R, -1, p)
        return [x * rinv % p for x in limbs_to_ints(a.reshape(-1, self.L))]

    def decode_scalar(self, a: torch.Tensor) -> int:
        return self.decode(a.reshape(1, -1))[0]


@functools.lru_cache(maxsize=None)
def _device_field(spec, device: str) -> DeviceField:
    return DeviceField(spec, device)


def device_field(spec, device="cuda") -> DeviceField:
    return _device_field(spec, str(torch.device(device)))

"""Radix-2 NTT over a power-of-two subgroup of Fr^*.

Port of the reference's `ops/ntt.py` `Domain` (`:46-206`): ntt, intt,
coset_ntt, coset_intt (coset generator `spec.generator`, as arkworks),
`divide_by_vanishing_poly_on_coset` and, for the setup, the Lagrange
coefficients at a point (`:206-247`). The transform is the reference's
iterative decimation-in-frequency ladder with one bit-reversal gather at
the end; every twiddle product goes through K1. Outputs are canonical, so
they are bit-equal to the reference's four-step transform
(`ops/ntt_large.py`), whose limb-major layout exists to avoid TPU lane
padding and is not ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .field import DeviceField, device_field


def _bitrev_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros_like(idx)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


class Domain:
    """Multiplicative subgroup of size n (a power of two) of Fr^*."""

    def __init__(self, df: DeviceField, n: int):
        assert n >= 1 and n & (n - 1) == 0
        self.df = df
        self.n = n
        p = df.spec.modulus
        self.omega = df.spec.root_of_unity(n)
        self.omega_inv = pow(self.omega, -1, p) if n > 1 else 1
        self.n_inv = pow(n, -1, p)
        self.coset_g = df.spec.generator
        self.coset_g_inv = pow(self.coset_g, -1, p)
        self._bitrev = torch.as_tensor(_bitrev_indices(n), device=df.device)
        # every power table the transforms use, built once (as the
        # reference's eager tables, `ops/ntt.py:76-81`)
        self._pows = {
            b: self._build_pow_table(b)
            for b in (self.omega, self.omega_inv, self.coset_g, self.coset_g_inv)
        }

    def _build_pow_table(self, base: int) -> torch.Tensor:
        """[base^0 .. base^(n-1)] as (n, L) Montgomery limbs, by doubling."""
        df = self.df
        table = df.ones((1,))
        w = df.encode([base])
        while table.shape[0] < self.n:
            table = torch.cat([table, df.mul(table, w)], dim=0)
            w = df.sqr(w)
        return table[: self.n]

    def fft(self, x: torch.Tensor, *, inverse: bool = False, coset: bool = False,
            dim: int = 0):
        """coset=True: forward evaluates on gH; inverse interpolates from gH.

        x holds n elements along `dim`; the other dims before the limbs are
        a batch of independent transforms (the four-step's row and column
        transforms, the reference's `jax.vmap` of `_fft_impl`)."""
        df, n, L = self.df, self.n, self.df.L
        assert x.shape[dim] == n and x.shape[-1] == L, (x.shape, n, dim)
        x = x.movedim(dim, 0)
        batch = x.shape[1:-1]
        x = x.reshape(n, -1, L)
        if coset and not inverse:
            x = df.mul(x, self._pows[self.coset_g].unsqueeze(1))
        if n > 1:
            table = self._pows[self.omega_inv if inverse else self.omega]
            for s in range(n.bit_length() - 1):
                half = n >> (s + 1)
                y = x.reshape(-1, 2, half, *x.shape[1:])
                a, b = y[:, 0], y[:, 1]
                top = df.add(a, b)
                bot = df.mul(df.sub(a, b), table[:: 1 << s][:half].unsqueeze(1).unsqueeze(0))
                x = torch.stack([top, bot], dim=1).reshape(x.shape)
            x = x[self._bitrev]
        if inverse:
            x = df.mul(x, df.const(self.n_inv, (1,)))
            if coset:
                x = df.mul(x, self._pows[self.coset_g_inv].unsqueeze(1))
        return x.reshape(n, *batch, L).movedim(0, dim)

    def ntt(self, coeffs):
        return self.fft(coeffs)

    def intt(self, evals):
        return self.fft(evals, inverse=True)

    def coset_ntt(self, coeffs):
        return self.fft(coeffs, coset=True)

    def coset_intt(self, evals):
        return self.fft(evals, inverse=True, coset=True)

    def divide_by_vanishing_poly_on_coset(self, evals):
        """evals of q on gH -> evals of q / (x^n - 1) on gH (constant divisor)."""
        p = self.df.spec.modulus
        zinv = pow(pow(self.coset_g, self.n, p) - 1, -1, p)
        return self.df.mul(evals, self.df.const(zinv, (1,)))

    def evaluate_vanishing_polynomial(self, tau: int) -> int:
        p = self.df.spec.modulus
        return (pow(tau, self.n, p) - 1) % p

    def evaluate_all_lagrange_coefficients(self, tau: int) -> torch.Tensor:
        """[L_i(tau)]_{i<n} as (n, L) Montgomery limbs: (tau^n - 1) w^i /
        (n (tau - w^i)), one batch inversion of the denominators; for tau
        inside the domain, L_i = delta_i (reference `ops/ntt.py:209-247`;
        its four-step route from 2^23 gives the same canonical values)."""
        df, n = self.df, self.n
        p = df.spec.modulus
        t = tau % p
        pow_w = self._pows[self.omega]
        if pow(t, n, p) == 1:
            idx, cur = 0, 1
            while cur != t:
                idx += 1
                cur = cur * self.omega % p
            out = df.zeros((n,))
            out[idx] = df.ones(())
            return out
        zt_over_n = self.evaluate_vanishing_polynomial(t) * self.n_inv % p
        num = df.mul(pow_w, df.const(zt_over_n, (1,)))
        den = df.sub(df.const(t, (1,)).expand(n, -1), pow_w)
        return df.mul(num, df.batch_inv(den))


@functools.lru_cache(maxsize=None)
def _get_domain(spec, n: int, device: str) -> Domain:
    return Domain(device_field(spec, device), n)


def get_domain(spec, n: int, device="cuda") -> Domain:
    """The one Domain of size n on `device` (reference `ops/ntt.py:250`):
    its index and power tables are built once per size, not per prove."""
    return _get_domain(spec, n, str(torch.device(device)))

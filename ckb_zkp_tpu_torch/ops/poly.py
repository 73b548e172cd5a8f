"""Dense polynomial arithmetic over Fr on torch tensors.

Port of the reference's `ops/poly.py` (the arkworks `DensePolynomial` ops
that KZG10 and Marlin use). Coefficients are (n, L) Montgomery limb
tensors, ascending degree; every product goes through K1 on a CUDA tensor.

The reference's `poly_divide_linear` is a `lax.scan` over the
coefficients (`ops/poly.py:65-86`); a loop over them here would be about
3n launches. The port computes the same Horner partials by distance
doubling: ceil(log2 n) rounds, each one product by a constant z^d and one
add. `poly_eval` sums its terms by a halving tree of adds where the
reference calls `scan_utils.blocked_reduce` (`:59`): the same field
element.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import DeviceField
from .limbs import ints_to_limbs, limbs_to_ints
from .ntt import get_domain


def encode_ints(df: DeviceField, xs) -> torch.Tensor:
    """Canonical ints (< p) -> (n, L) Montgomery limbs on df's device: the
    limbs go up as they are and K1 converts them (no Python-int product an
    element, as `df.encode` pays)."""
    raw = ints_to_limbs(xs, df.L).view(np.int32)
    return df.to_mont(torch.as_tensor(raw, device=df.device))


def decode_ints(df: DeviceField, a: torch.Tensor) -> list[int]:
    """(n, L) Montgomery limbs -> canonical ints, converted by K1."""
    return limbs_to_ints(df.from_mont(a))


def poly_add(df: DeviceField, a, b):
    n = max(a.shape[0], b.shape[0])
    return df.add(pad_to(df, a, n), pad_to(df, b, n))


def poly_sub(df: DeviceField, a, b):
    n = max(a.shape[0], b.shape[0])
    return df.sub(pad_to(df, a, n), pad_to(df, b, n))


def pad_to(df: DeviceField, a, n: int):
    if a.shape[0] >= n:
        return a
    return torch.cat([a, a.new_zeros((n - a.shape[0], df.L))])


def poly_scale(df: DeviceField, a, c: int):
    return df.mul(a, df.const(c, (1,)))


def poly_mul(df: DeviceField, a, b):
    """Product via NTT on a domain of size >= deg(a)+deg(b)+1."""
    out_len = a.shape[0] + b.shape[0] - 1
    n = 1
    while n < out_len:
        n *= 2
    dom = get_domain(df.spec, n, df.device)
    ea = dom.ntt(pad_to(df, a, n))
    eb = dom.ntt(pad_to(df, b, n))
    return dom.intt(df.mul(ea, eb))[:out_len]


def poly_eval(df: DeviceField, coeffs, x: int):
    """Evaluate at a host scalar x; returns the (L,) Montgomery element:
    the terms c_i x^i summed by a halving tree of adds."""
    terms = df.mul(coeffs, df.powers(x, coeffs.shape[0]))
    while terms.shape[0] > 1:
        if terms.shape[0] % 2:
            terms = torch.cat([terms, terms.new_zeros((1, df.L))])
        terms = df.add(terms[0::2], terms[1::2])
    return terms[0]


def poly_divide_linear(df: DeviceField, coeffs, z: int):
    """(q, r) with p(x) = q(x) * (x - z) + r: synthetic division.

    The Horner partials h_k = c_{n-1-k} + z h_{k-1} (high to low) are a
    prefix of the coefficients under x -> z x + c; after the rounds d = 1,
    2, 4, ... of h_k += z^d h_{k-d} (k >= d), h_k = sum_{i <= k} z^(k-i)
    c_{n-1-i}. The first n - 1 partials are the quotient's coefficients
    (descending); the last is the remainder p(z). z = 0 needs no branch:
    every z^d is 0 and h = the coefficients reversed."""
    n = coeffs.shape[0]
    if n == 1:
        return coeffs.new_zeros((1, df.L)), coeffs[0]
    p = df.spec.modulus
    h = coeffs.flip(0)
    d = 1
    while d < n:
        zd = df.const(pow(z, d, p), (1,))
        h = torch.cat([h[:d], df.add(h[d:], df.mul(h[:-d], zd))])
        d *= 2
    return h[: n - 1].flip(0), h[n - 1]

"""Twisted-Edwards point arithmetic for ristretto255 (curve25519) on torch.

Port of the reference's `ops/edwards.py`. Points are tuples (X, Y, Z, T)
of extended coordinates with a = -1, each a (..., L) int32 tensor of
Montgomery limbs over Fq = 2^255 - 19 (`DeviceField`, L = 16). The
unified addition (add-2008-hwcd-3) is complete on the Ristretto group:
identity, doubling and inverse cases take the same 8-multiply formula,
with no selects. Every product is K1 (`DeviceField.mul`, a `mont_mul`
launch on a CUDA tensor), as every product of 256 rows or more was the
Pallas K1 on the TPU; add, sub and neg are plain torch, as elsewhere in
the port.
"""

from __future__ import annotations

import torch

from .field import DeviceField


def ed_identity(df: DeviceField, batch_shape=()):
    """(0, 1, 1, 0): the Edwards identity, a valid input to ed_add/ed_double."""
    return (df.zeros(batch_shape), df.ones(batch_shape), df.ones(batch_shape),
            df.zeros(batch_shape))


def ed_add(df: DeviceField, d2_mont: torch.Tensor, p, q):
    """Unified extended addition, a = -1 (add-2008-hwcd-3): 8M + 8 adds.
    `d2_mont` is 2d in Montgomery form. Complete on the Ristretto group
    (P == Q, P == -Q and the identity included), as the host
    `RistrettoGroup.add` is."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = df.mul(df.sub(Y1, X1), df.sub(Y2, X2))
    B = df.mul(df.add(Y1, X1), df.add(Y2, X2))
    C = df.mul(df.mul(T1, d2_mont), T2)
    D = df.mul(Z1, Z2)
    D = df.add(D, D)
    E = df.sub(B, A)
    F = df.sub(D, C)
    G = df.add(D, C)
    H = df.add(B, A)
    return (df.mul(E, F), df.mul(G, H), df.mul(F, G), df.mul(E, H))


def ed_double(df: DeviceField, p):
    """Dedicated doubling (dbl-2008-hwcd), a = -1: 4M + 4S. Identity-safe."""
    X1, Y1, Z1, _ = p
    A = df.sqr(X1)
    B = df.sqr(Y1)
    Zsq = df.sqr(Z1)
    C = df.add(Zsq, Zsq)
    H = df.add(A, B)
    XY = df.add(X1, Y1)
    E = df.sub(H, df.sqr(XY))
    G = df.sub(A, B)
    F = df.add(C, G)
    return (df.mul(E, F), df.mul(G, H), df.mul(F, G), df.mul(E, H))


def ed_neg(df: DeviceField, p):
    X, Y, Z, T = p
    return (df.neg(X), Y, Z, df.neg(T))

# Copied from ckb_zkp_tpu/host/field.py (host ints and numpy only): the port keeps its own copy.
"""Host-side exact prime-field arithmetic over Python integers.

This is the *oracle and verifier* layer of the framework: pairings, transcripts,
twiddle-factor generation and all O(1)-per-proof math run here, while the bulk
prover math (NTT / MSM / witness maps) runs on TPU via the limb-decomposed
kernels in :mod:`ckb_zkp_tpu.ops`.

Role parity with the reference: replaces the `ark-ff` Fp256/Fp384 host types
used throughout sec-bit/ckb-zkp (e.g. ckb-zkp groth16/src/prover.rs:152-161),
but re-designed: we keep canonical integer representation on the host (Montgomery
form is a *device-side* representation choice, see ops/mont.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass


def _tonelli_shanks(a: int, p: int) -> int | None:
    """Square root mod odd prime p, or None if a is a non-residue."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # general Tonelli-Shanks
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        t2, i = t, 0
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field.

    ``two_adicity``/``two_adic_root`` describe the largest power-of-two
    subgroup of the multiplicative group (the NTT domain), mirroring
    arkworks' `FpParameters::TWO_ADICITY` / `ROOT_OF_UNITY`.
    """

    name: str
    modulus: int
    generator: int  # smallest multiplicative generator (arkworks GENERATOR)

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def nbytes(self) -> int:
        """Serialized byte length (arkworks: ceil(bits/64)*8 little-endian bytes)."""
        n64 = (self.bits + 63) // 64
        return n64 * 8

    @functools.cached_property
    def two_adicity(self) -> int:
        t, n = self.modulus - 1, 0
        while t % 2 == 0:
            t //= 2
            n += 1
        return n

    @functools.cached_property
    def two_adic_root(self) -> int:
        """Generator of the order-2^two_adicity subgroup."""
        odd = (self.modulus - 1) >> self.two_adicity
        return pow(self.generator, odd, self.modulus)

    def root_of_unity(self, order: int) -> int:
        """Primitive `order`-th root of unity (order must be a power of two)."""
        assert order & (order - 1) == 0
        k = order.bit_length() - 1
        if k > self.two_adicity:
            raise ValueError(
                f"{self.name}: no 2^{k} root of unity (two_adicity={self.two_adicity})"
            )
        return pow(self.two_adic_root, 1 << (self.two_adicity - k), self.modulus)

    # --- scalar ops (mod p) -------------------------------------------------
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.modulus

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.modulus

    def mul(self, a: int, b: int) -> int:
        return a * b % self.modulus

    def neg(self, a: int) -> int:
        return -a % self.modulus

    def inv(self, a: int) -> int:
        if a % self.modulus == 0:
            raise ZeroDivisionError(f"inverse of 0 in {self.name}")
        return pow(a, -1, self.modulus)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.modulus)

    def sqrt(self, a: int) -> int | None:
        return _tonelli_shanks(a, self.modulus)

    def legendre_is_qr(self, a: int) -> bool:
        a %= self.modulus
        return a == 0 or pow(a, (self.modulus - 1) // 2, self.modulus) == 1

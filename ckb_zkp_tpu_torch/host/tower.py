# Copied from ckb_zkp_tpu/host/tower.py (host ints and numpy only): the port keeps its own copy.
"""Extension-field towers Fq2 / Fq6 / Fq12 over Python integers (host side).

Used by the pairing engine (host verifier path). Representation:
  Fq2  element: tuple (a0, a1)            = a0 + a1*u,   u^2 = beta (= -1)
  Fq6  element: tuple (c0, c1, c2) of Fq2 = c0 + c1*v + c2*v^2,  v^3 = xi
  Fq12 element: tuple (d0, d1) of Fq6     = d0 + d1*w,   w^2 = v

Parity: replaces arkworks' `ark_ff::{Fp2, Fp6, Fp12}` used by the reference's
pairing-based verifiers (ckb-zkp groth16/src/verifier.rs:32-41).
"""

from __future__ import annotations

import functools

Fq2E = tuple[int, int]
Fq6E = tuple[Fq2E, Fq2E, Fq2E]
Fq12E = tuple[Fq6E, Fq6E]


class Tower:
    """Arithmetic context for the Fq2/Fq6/Fq12 tower of a pairing curve.

    ``xi`` is the Fq2 sextic non-residue used for Fq6 (v^3 = xi). We require
    q % 4 == 3 so that u^2 = -1 is a valid (non-residue) choice — true for
    both BN254 and BLS12-381.
    """

    def __init__(self, q: int, xi: Fq2E):
        assert q % 4 == 3, "tower assumes q = 3 mod 4 (u^2 = -1 non-residue)"
        self.q = q
        self.xi = (xi[0] % q, xi[1] % q)

    # ---------------- Fq2 ----------------
    def f2(self, a0: int, a1: int = 0) -> Fq2E:
        return (a0 % self.q, a1 % self.q)

    ZERO2: Fq2E = (0, 0)
    ONE2: Fq2E = (1, 0)

    def f2_add(self, a: Fq2E, b: Fq2E) -> Fq2E:
        q = self.q
        return ((a[0] + b[0]) % q, (a[1] + b[1]) % q)

    def f2_sub(self, a: Fq2E, b: Fq2E) -> Fq2E:
        q = self.q
        return ((a[0] - b[0]) % q, (a[1] - b[1]) % q)

    def f2_neg(self, a: Fq2E) -> Fq2E:
        q = self.q
        return (-a[0] % q, -a[1] % q)

    def f2_mul(self, a: Fq2E, b: Fq2E) -> Fq2E:
        q = self.q
        # u^2 = -1
        t0 = a[0] * b[0]
        t1 = a[1] * b[1]
        return ((t0 - t1) % q, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % q)

    def f2_sqr(self, a: Fq2E) -> Fq2E:
        q = self.q
        return ((a[0] + a[1]) * (a[0] - a[1]) % q, 2 * a[0] * a[1] % q)

    def f2_scalar(self, a: Fq2E, k: int) -> Fq2E:
        q = self.q
        return (a[0] * k % q, a[1] * k % q)

    def f2_conj(self, a: Fq2E) -> Fq2E:
        return (a[0], -a[1] % self.q)

    def f2_inv(self, a: Fq2E) -> Fq2E:
        q = self.q
        norm = (a[0] * a[0] + a[1] * a[1]) % q
        ninv = pow(norm, -1, q)
        return (a[0] * ninv % q, -a[1] * ninv % q)

    def f2_pow(self, a: Fq2E, e: int) -> Fq2E:
        r: Fq2E = (1, 0)
        base = a
        while e > 0:
            if e & 1:
                r = self.f2_mul(r, base)
            base = self.f2_sqr(base)
            e >>= 1
        return r

    def f2_mul_by_xi(self, a: Fq2E) -> Fq2E:
        return self.f2_mul(a, self.xi)

    # ---------------- Fq6 ----------------
    @property
    def ZERO6(self) -> Fq6E:
        return ((0, 0), (0, 0), (0, 0))

    @property
    def ONE6(self) -> Fq6E:
        return ((1, 0), (0, 0), (0, 0))

    def f6_add(self, a: Fq6E, b: Fq6E) -> Fq6E:
        return tuple(self.f2_add(x, y) for x, y in zip(a, b))  # type: ignore

    def f6_sub(self, a: Fq6E, b: Fq6E) -> Fq6E:
        return tuple(self.f2_sub(x, y) for x, y in zip(a, b))  # type: ignore

    def f6_neg(self, a: Fq6E) -> Fq6E:
        return tuple(self.f2_neg(x) for x in a)  # type: ignore

    def f6_mul(self, a: Fq6E, b: Fq6E) -> Fq6E:
        m, xi = self.f2_mul, self.f2_mul_by_xi
        add, sub = self.f2_add, self.f2_sub
        v0 = m(a[0], b[0])
        v1 = m(a[1], b[1])
        v2 = m(a[2], b[2])
        # Karatsuba-style (Toom) interpolation, v^3 = xi
        c0 = add(v0, xi(sub(sub(m(add(a[1], a[2]), add(b[1], b[2])), v1), v2)))
        c1 = add(sub(sub(m(add(a[0], a[1]), add(b[0], b[1])), v0), v1), xi(v2))
        c2 = add(sub(sub(m(add(a[0], a[2]), add(b[0], b[2])), v0), v2), v1)
        return (c0, c1, c2)

    def f6_sqr(self, a: Fq6E) -> Fq6E:
        return self.f6_mul(a, a)

    def f6_mul_by_v(self, a: Fq6E) -> Fq6E:
        # (c0 + c1 v + c2 v^2) * v = xi*c2 + c0 v + c1 v^2
        return (self.f2_mul_by_xi(a[2]), a[0], a[1])

    def f6_inv(self, a: Fq6E) -> Fq6E:
        m, xi, sub = self.f2_mul, self.f2_mul_by_xi, self.f2_sub
        c0 = sub(self.f2_sqr(a[0]), xi(m(a[1], a[2])))
        c1 = sub(xi(self.f2_sqr(a[2])), m(a[0], a[1]))
        c2 = sub(self.f2_sqr(a[1]), m(a[0], a[2]))
        t = self.f2_add(self.f2_add(m(a[0], c0), xi(m(a[2], c1))), xi(m(a[1], c2)))
        tinv = self.f2_inv(t)
        return (m(c0, tinv), m(c1, tinv), m(c2, tinv))

    # ---------------- Fq12 ----------------
    @property
    def ZERO12(self) -> Fq12E:
        return (self.ZERO6, self.ZERO6)

    @property
    def ONE12(self) -> Fq12E:
        return (self.ONE6, self.ZERO6)

    def f12_add(self, a: Fq12E, b: Fq12E) -> Fq12E:
        return (self.f6_add(a[0], b[0]), self.f6_add(a[1], b[1]))

    def f12_sub(self, a: Fq12E, b: Fq12E) -> Fq12E:
        return (self.f6_sub(a[0], b[0]), self.f6_sub(a[1], b[1]))

    def f12_mul(self, a: Fq12E, b: Fq12E) -> Fq12E:
        v0 = self.f6_mul(a[0], b[0])
        v1 = self.f6_mul(a[1], b[1])
        c0 = self.f6_add(v0, self.f6_mul_by_v(v1))
        c1 = self.f6_sub(
            self.f6_mul(self.f6_add(a[0], a[1]), self.f6_add(b[0], b[1])),
            self.f6_add(v0, v1),
        )
        return (c0, c1)

    def f12_sqr(self, a: Fq12E) -> Fq12E:
        return self.f12_mul(a, a)

    def f12_conj(self, a: Fq12E) -> Fq12E:
        """Conjugation = Frobenius^6 = inversion for unitary (cyclotomic) elements."""
        return (a[0], self.f6_neg(a[1]))

    def f12_inv(self, a: Fq12E) -> Fq12E:
        t = self.f6_sub(self.f6_sqr(a[0]), self.f6_mul_by_v(self.f6_sqr(a[1])))
        tinv = self.f6_inv(t)
        return (self.f6_mul(a[0], tinv), self.f6_neg(self.f6_mul(a[1], tinv)))

    def f12_pow(self, a: Fq12E, e: int) -> Fq12E:
        if e < 0:
            return self.f12_pow(self.f12_inv(a), -e)
        r = self.ONE12
        base = a
        while e > 0:
            if e & 1:
                r = self.f12_mul(r, base)
            base = self.f12_sqr(base)
            e >>= 1
        return r

    def f12_scalar_fq2(self, a: Fq12E, s: Fq2E) -> Fq12E:
        """Multiply every Fq2 coefficient by s."""
        m = self.f2_mul
        return (
            (m(a[0][0], s), m(a[0][1], s), m(a[0][2], s)),
            (m(a[1][0], s), m(a[1][1], s), m(a[1][2], s)),
        )

    # -------- sextic-basis view & Frobenius --------
    # Fq12 = Fq2[w]/(w^6 - xi); tower basis (1,v,v^2) x (1,w) maps to
    # w-powers [1, w, w^2=v, w^3=v*w, w^4=v^2, w^5=v^2*w].
    def to_sextic(self, a: Fq12E) -> list[Fq2E]:
        return [a[0][0], a[1][0], a[0][1], a[1][1], a[0][2], a[1][2]]

    def from_sextic(self, c: list[Fq2E]) -> Fq12E:
        return ((c[0], c[2], c[4]), (c[1], c[3], c[5]))

    @functools.cached_property
    def frob_coeffs(self) -> list[Fq2E]:
        """gamma_i = xi^(i*(q-1)/6) for i in 0..5 — w^(q) = gamma_1 * w etc."""
        e = (self.q - 1) // 6
        g1 = self.f2_pow(self.xi, e)
        out = [self.ONE2]
        for _ in range(5):
            out.append(self.f2_mul(out[-1], g1))
        return out

    def f12_frobenius(self, a: Fq12E, power: int = 1) -> Fq12E:
        r = a
        for _ in range(power % 12):
            c = self.to_sextic(r)
            c = [
                self.f2_mul(self.f2_conj(ci), self.frob_coeffs[i])
                for i, ci in enumerate(c)
            ]
            r = self.from_sextic(c)
        return r

# Copied from ckb_zkp_tpu/host/curves.py (host ints and numpy only): the port keeps its own copy.
"""Host-side short-Weierstrass elliptic curve groups (exact, Python ints).

Generic over the coordinate field so the same code serves G1 (Fq), G2 (Fq2)
and the untwisted E(Fq12) needed by the Miller loop.

Parity: replaces `ark-ec`'s `AffineCurve/ProjectiveCurve` host types used by
the reference (e.g. ckb-zkp curve/src/lib.rs:20-46). Bulk scalar-muls
and MSMs run on TPU (ops/msm.py); this layer is the O(1) verifier/oracle path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generic, TypeVar

F = TypeVar("F")


class FieldOps(Generic[F]):
    """Minimal field interface for generic curve formulas."""

    zero: F
    one: F

    def add(self, a: F, b: F) -> F: ...
    def sub(self, a: F, b: F) -> F: ...
    def mul(self, a: F, b: F) -> F: ...
    def neg(self, a: F) -> F: ...
    def inv(self, a: F) -> F: ...

    def sqr(self, a: F) -> F:
        return self.mul(a, a)

    def eq(self, a: F, b: F) -> bool:
        return a == b

    def is_zero(self, a: F) -> bool:
        return self.eq(a, self.zero)

    def scalar(self, a: F, k: int) -> F:
        """a * small-int k."""
        r = self.zero
        base = a
        while k > 0:
            if k & 1:
                r = self.add(r, base)
            base = self.add(base, base)
            k >>= 1
        return r


class IntField(FieldOps[int]):
    def __init__(self, q: int):
        self.q = q
        self.zero = 0
        self.one = 1

    def add(self, a, b):
        return (a + b) % self.q

    def sub(self, a, b):
        return (a - b) % self.q

    def mul(self, a, b):
        return a * b % self.q

    def neg(self, a):
        return -a % self.q

    def inv(self, a):
        return pow(a, -1, self.q)

    def scalar(self, a, k):
        return a * k % self.q


class Fq2Field(FieldOps):
    def __init__(self, tower):
        self.t = tower
        self.zero = (0, 0)
        self.one = (1, 0)

    def add(self, a, b):
        return self.t.f2_add(a, b)

    def sub(self, a, b):
        return self.t.f2_sub(a, b)

    def mul(self, a, b):
        return self.t.f2_mul(a, b)

    def neg(self, a):
        return self.t.f2_neg(a)

    def inv(self, a):
        return self.t.f2_inv(a)

    def scalar(self, a, k):
        return self.t.f2_scalar(a, k)


class Fq12Field(FieldOps):
    def __init__(self, tower):
        self.t = tower
        self.zero = tower.ZERO12
        self.one = tower.ONE12

    def add(self, a, b):
        return self.t.f12_add(a, b)

    def sub(self, a, b):
        return self.t.f12_sub(a, b)

    def mul(self, a, b):
        return self.t.f12_mul(a, b)

    def neg(self, a):
        return self.t.f12_sub(self.t.ZERO12, a)

    def inv(self, a):
        return self.t.f12_inv(a)


@dataclass
class AffinePoint(Generic[F]):
    """Affine point; ``infinity=True`` ignores x/y (mirrors ark's SW affine)."""

    x: F
    y: F
    infinity: bool = False

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, AffinePoint):
            return NotImplemented
        if self.infinity or other.infinity:
            return self.infinity == other.infinity
        return self.x == other.x and self.y == other.y

    def __hash__(self):
        return hash(("pt", repr(self.x), repr(self.y), self.infinity))


class WeierstrassGroup(Generic[F]):
    """y^2 = x^3 + a*x + b over a FieldOps instance."""

    def __init__(self, field: FieldOps[F], a: F, b: F, order: int):
        self.f = field
        self.a = a
        self.b = b
        self.order = order  # prime subgroup order r
        self._a_is_zero = field.is_zero(a)

    @property
    def infinity(self) -> AffinePoint[F]:
        return AffinePoint(self.f.zero, self.f.zero, True)

    def is_on_curve(self, p: AffinePoint[F]) -> bool:
        if p.infinity:
            return True
        f = self.f
        lhs = f.sqr(p.y)
        rhs = f.add(f.add(f.mul(f.sqr(p.x), p.x), f.mul(self.a, p.x)), self.b)
        return f.eq(lhs, rhs)

    def neg(self, p: AffinePoint[F]) -> AffinePoint[F]:
        if p.infinity:
            return p
        return AffinePoint(p.x, self.f.neg(p.y))

    def double(self, p: AffinePoint[F]) -> AffinePoint[F]:
        if p.infinity:
            return p
        f = self.f
        if f.is_zero(p.y):
            return self.infinity
        # lambda = (3x^2 + a) / 2y
        num = f.add(f.scalar(f.sqr(p.x), 3), self.a)
        lam = f.mul(num, f.inv(f.scalar(p.y, 2)))
        x3 = f.sub(f.sqr(lam), f.scalar(p.x, 2))
        y3 = f.sub(f.mul(lam, f.sub(p.x, x3)), p.y)
        return AffinePoint(x3, y3)

    def add(self, p: AffinePoint[F], q: AffinePoint[F]) -> AffinePoint[F]:
        if p.infinity:
            return q
        if q.infinity:
            return p
        f = self.f
        if f.eq(p.x, q.x):
            if f.eq(p.y, q.y):
                return self.double(p)
            return self.infinity
        lam = f.mul(f.sub(q.y, p.y), f.inv(f.sub(q.x, p.x)))
        x3 = f.sub(f.sub(f.sqr(lam), p.x), q.x)
        y3 = f.sub(f.mul(lam, f.sub(p.x, x3)), p.y)
        return AffinePoint(x3, y3)

    def sub(self, p: AffinePoint[F], q: AffinePoint[F]) -> AffinePoint[F]:
        return self.add(p, self.neg(q))

    # ---- Jacobian internals: host muls/MSMs avoid the per-add modular
    # inversion of the affine formulas (measured: one pow(x,-1,p) costs
    # ~40 modmuls), paying one inversion per result instead of per step ----

    def _j_from_affine(self, p: AffinePoint[F]):
        if p.infinity:
            return None
        return (p.x, p.y, self.f.one)

    def _j_to_affine(self, P) -> AffinePoint[F]:
        if P is None:
            return self.infinity
        f = self.f
        x, y, z = P
        zinv = f.inv(z)
        zinv2 = f.sqr(zinv)
        return AffinePoint(f.mul(x, zinv2), f.mul(y, f.mul(zinv, zinv2)))

    def _j_double(self, P):
        if P is None:
            return None
        f = self.f
        x, y, z = P
        if f.is_zero(y):
            return None
        xx = f.sqr(x)
        yy = f.sqr(y)
        yyyy = f.sqr(yy)
        zz = f.sqr(z)
        # S = 2*((X+YY)^2 - XX - YYYY)
        s = f.scalar(f.sub(f.sub(f.sqr(f.add(x, yy)), xx), yyyy), 2)
        m = f.scalar(xx, 3)
        if not self._a_is_zero:
            m = f.add(m, f.mul(self.a, f.sqr(zz)))
        x3 = f.sub(f.sqr(m), f.scalar(s, 2))
        y3 = f.sub(f.mul(m, f.sub(s, x3)), f.scalar(yyyy, 8))
        z3 = f.sub(f.sub(f.sqr(f.add(y, z)), yy), zz)
        return (x3, y3, z3)

    def _j_add_affine(self, P, q: AffinePoint[F]):
        """Mixed add P (Jacobian) + q (affine)."""
        if q.infinity:
            return P
        if P is None:
            return (q.x, q.y, self.f.one)
        f = self.f
        x1, y1, z1 = P
        z1z1 = f.sqr(z1)
        u2 = f.mul(q.x, z1z1)
        s2 = f.mul(f.mul(q.y, z1), z1z1)
        h = f.sub(u2, x1)
        r = f.sub(s2, y1)
        if f.is_zero(h):
            if f.is_zero(r):
                return self._j_double(P)
            return None
        hh = f.sqr(h)
        hhh = f.mul(h, hh)
        v = f.mul(x1, hh)
        x3 = f.sub(f.sub(f.sqr(r), hhh), f.scalar(v, 2))
        y3 = f.sub(f.mul(r, f.sub(v, x3)), f.mul(y1, hhh))
        z3 = f.mul(z1, h)
        return (x3, y3, z3)

    def _j_add(self, P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        f = self.f
        x1, y1, z1 = P
        x2, y2, z2 = Q
        z1z1 = f.sqr(z1)
        z2z2 = f.sqr(z2)
        u1 = f.mul(x1, z2z2)
        u2 = f.mul(x2, z1z1)
        s1 = f.mul(f.mul(y1, z2), z2z2)
        s2 = f.mul(f.mul(y2, z1), z1z1)
        h = f.sub(u2, u1)
        r = f.sub(s2, s1)
        if f.is_zero(h):
            if f.is_zero(r):
                return self._j_double(P)
            return None
        hh = f.sqr(h)
        hhh = f.mul(h, hh)
        v = f.mul(u1, hh)
        x3 = f.sub(f.sub(f.sqr(r), hhh), f.scalar(v, 2))
        y3 = f.sub(f.mul(r, f.sub(v, x3)), f.mul(s1, hhh))
        z3 = f.mul(f.mul(z1, z2), h)
        return (x3, y3, z3)

    def mul(self, p: AffinePoint[F], k: int) -> AffinePoint[F]:
        k %= self.order
        if k == 0 or p.infinity:
            return self.infinity
        # left-to-right double-and-add on Jacobian coords, mixed adds
        r = None
        for i in range(k.bit_length() - 1, -1, -1):
            r = self._j_double(r)
            if (k >> i) & 1:
                r = self._j_add_affine(r, p)
        return self._j_to_affine(r)

    def _j_to_affine_many(self, Ps) -> list[AffinePoint[F]]:
        """Batch Jacobian -> affine: one inversion total (Montgomery trick)."""
        f = self.f
        idx = [i for i, P in enumerate(Ps) if P is not None]
        zs = [Ps[i][2] for i in idx]
        # prefix products
        pre = []
        acc = f.one
        for z in zs:
            acc = f.mul(acc, z)
            pre.append(acc)
        inv_acc = f.inv(acc) if zs else f.one
        zinvs = [f.zero] * len(zs)
        for j in range(len(zs) - 1, -1, -1):
            if j == 0:
                zinvs[0] = inv_acc
            else:
                zinvs[j] = f.mul(inv_acc, pre[j - 1])
                inv_acc = f.mul(inv_acc, zs[j])
        out = [self.infinity] * len(Ps)
        for j, i in enumerate(idx):
            x, y, _ = Ps[i]
            zi2 = f.sqr(zinvs[j])
            out[i] = AffinePoint(f.mul(x, zi2), f.mul(y, f.mul(zinvs[j], zi2)))
        return out

    def window_table(
        self, base: AffinePoint[F], c: int, nwin: int
    ) -> list[list[AffinePoint[F]]]:
        """Fixed-base window table rows T[w][d] = d * 2^(cw) * base, affine.

        Row w has 2^c entries, d = 0 (infinity) .. 2^c - 1. Host counterpart
        of arkworks' FixedBaseMSM table
        (ckb-zkp groth16/src/generator.rs:206-256); one batch
        normalization (single inversion) for the whole table."""
        assert c >= 1, "window size must be at least 1 bit"
        if base.infinity:
            return [[self.infinity] * (1 << c) for _ in range(nwin)]
        rows_j = []
        cur = self._j_from_affine(base)
        for _ in range(nwin):
            row = [None] * ((1 << c) - 1)
            row[0] = cur
            for d in range(1, (1 << c) - 1):
                row[d] = self._j_add(row[d - 1], cur)
            rows_j.append(row)
            cur = self._j_add(row[-1], cur)  # 2^c * (2^(cw) * base)
        flat = self._j_to_affine_many([e for row in rows_j for e in row])
        k = (1 << c) - 1
        return [
            [self.infinity] + flat[i * k : (i + 1) * k] for i in range(nwin)
        ]

    def fixed_base_mul_many(
        self, base: AffinePoint[F], scalars: list[int], c: int = 4
    ) -> list[AffinePoint[F]]:
        """[k*base for k in scalars] via one shared window table: each scalar
        costs ceil(bits/c) mixed adds and no doublings."""
        if base.infinity:
            return [self.infinity] * len(scalars)
        nbits = self.order.bit_length()
        nwin = -(-nbits // c)
        # memoize the shared window table: protocol layers call this
        # repeatedly for the same generator point (ADVICE r2)
        cache = getattr(self, "_fb_table_cache", None)
        if cache is None:
            cache = self._fb_table_cache = {}
        key = (base.x, base.y, c, nwin)
        rows = cache.get(key)
        if rows is None:
            rows = [row[1:] for row in self.window_table(base, c, nwin)]
            if len(cache) < 16:
                cache[key] = rows
        outs = []
        mask = (1 << c) - 1
        for s in scalars:
            s %= self.order
            acc = None
            for w in range(nwin):
                d = (s >> (w * c)) & mask
                if d:
                    acc = self._j_add_affine(acc, rows[w][d - 1])
            outs.append(acc)
        return self._j_to_affine_many(outs)

    def msm(self, points: list[AffinePoint[F]], scalars: list[int]) -> AffinePoint[F]:
        """Host Pippenger MSM (Jacobian buckets, one final inversion).

        Oracle/CPU path for the TPU Pippenger kernel (ops/msm.py); same
        window/bucket structure as arkworks' VariableBaseMSM
        (ckb-zkp curve/src/lib.rs:38-45 delegates there).
        """
        pairs = [
            (p, s % self.order)
            for p, s in zip(points, scalars)
            if not p.infinity and s % self.order
        ]
        if not pairs:
            return self.infinity
        if len(pairs) == 1:
            return self.mul(*pairs[0])
        n = len(pairs)
        c = min(13, max(3, n.bit_length() - 2))
        nbits = self.order.bit_length()
        nwin = -(-nbits // c)
        total = None
        for w in range(nwin - 1, -1, -1):
            if total is not None:
                for _ in range(c):
                    total = self._j_double(total)
            buckets: dict[int, Any] = {}
            shift = w * c
            mask = (1 << c) - 1
            for p, s in pairs:
                d = (s >> shift) & mask
                if d:
                    buckets[d] = self._j_add_affine(buckets.get(d), p)
            if not buckets:
                continue
            # running-sum bucket reduction: sum_d d*B_d
            acc = None
            wsum = None
            for d in range(max(buckets), 0, -1):
                b = buckets.get(d)
                if b is not None:
                    acc = self._j_add(acc, b)
                wsum = self._j_add(wsum, acc)
            total = self._j_add(total, wsum)
        return self._j_to_affine(total)

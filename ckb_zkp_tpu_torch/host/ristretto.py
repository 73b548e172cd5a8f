# Copied from ckb_zkp_tpu/host/ristretto.py (host ints only): the port keeps its own copy.
"""Ristretto255 group over Curve25519 (host exact math).

Parity: the `zkp-curve25519` crate (ckb-zkp curve25519/src/) — a
non-pairing `Curve` backend for Spartan/Hyrax/Bulletproofs: the Ristretto
prime-order group (wrapping curve25519-dalek in the reference,
group.rs:21-48) with 32-byte compressed encoding (group.rs:293-338) and the
Ristretto scalar field Fr of order 2^252 + δ (fr.rs:6-100, TWO_ADICITY=2 —
no NTT on this curve, by design).

Implementation: Edwards25519 extended coordinates + the ristretto255
encode/decode maps (RFC 9496). Everything is exact Python-int math; the
sqrt-ratio uses the p ≡ 5 (mod 8) shortcut.
"""

from __future__ import annotations

from dataclasses import dataclass

from .field import FieldSpec

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493  # group order
D = (-121665 * pow(121666, -1, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1), the canonical-even one
if SQRT_M1 % 2 == 1:
    SQRT_M1 = P - SQRT_M1
# dalek picks sqrt(-1) = sqrt(-486664)... canonical constant: even representative
SQRT_AD_MINUS_ONE = None  # unused (no elligator map needed)


def _is_negative(x: int) -> bool:
    return (x % P) & 1 == 1


def _sqrt_ratio_i(u: int, v: int) -> tuple[bool, int]:
    """(was_square, sqrt(u/v)) — nonnegative root; if u/v is non-square,
    returns sqrt(SQRT_M1 * u/v). RFC 9496 §4.2 / dalek sqrt_ratio_i."""
    u %= P
    v %= P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    correct = (check - u) % P == 0
    flipped = (check + u) % P == 0
    flipped_i = (check + u * SQRT_M1) % P == 0
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    was_square = correct or flipped
    if _is_negative(r):
        r = P - r
    return was_square, r


INVSQRT_A_MINUS_D = _sqrt_ratio_i(1, (-1 - D) % P)[1]


@dataclass
class RistrettoPoint:
    """Extended Edwards coordinates (X, Y, Z, T); x=X/Z, y=Y/Z, T=XY/Z."""

    X: int
    Y: int
    Z: int
    T: int

    def __eq__(self, other) -> bool:
        if not isinstance(other, RistrettoPoint):
            return NotImplemented
        # ristretto equality: X1*Y2 == Y1*X2 or Y1*Y2 == X1*X2
        a = (self.X * other.Y - self.Y * other.X) % P == 0
        b = (self.Y * other.Y - self.X * other.X) % P == 0
        return a or b

    def __hash__(self):
        return hash(self.encode())

    @property
    def infinity(self) -> bool:  # interface parity with AffinePoint
        return self == IDENTITY

    def encode(self) -> bytes:
        """ristretto255 compression (RFC 9496 §4.3.2) -> 32 bytes."""
        X, Y, Z, T = self.X % P, self.Y % P, self.Z % P, self.T % P
        u1 = (Z + Y) * (Z - Y) % P
        u2 = X * Y % P
        _, invsqrt = _sqrt_ratio_i(1, u1 * u2 % P * u2 % P)
        den1 = invsqrt * u1 % P
        den2 = invsqrt * u2 % P
        z_inv = den1 * den2 % P * T % P
        if _is_negative(T * z_inv % P):
            ix = X * SQRT_M1 % P
            iy = Y * SQRT_M1 % P
            x, y = iy, ix
            den_inv = den1 * INVSQRT_A_MINUS_D % P
        else:
            x, y = X, Y
            den_inv = den2
        if _is_negative(x * z_inv % P):
            y = P - y
        s = den_inv * ((Z - y) % P) % P
        if _is_negative(s):
            s = P - s
        return s.to_bytes(32, "little")

    @classmethod
    def decode(cls, data: bytes) -> "RistrettoPoint | None":
        """ristretto255 decompression (RFC 9496 §4.3.1); None if invalid."""
        if len(data) != 32:
            return None
        s = int.from_bytes(data, "little")
        if s >= P or _is_negative(s):
            return None
        ss = s * s % P
        u1 = (1 - ss) % P
        u2 = (1 + ss) % P
        u2_sqr = u2 * u2 % P
        v = (-(D * u1 % P * u1) - u2_sqr) % P
        ok, invsqrt = _sqrt_ratio_i(1, v * u2_sqr % P)
        den_x = invsqrt * u2 % P
        den_y = invsqrt * den_x % P * v % P
        x = (s + s) % P * den_x % P
        if _is_negative(x):
            x = P - x
        y = u1 * den_y % P
        t = x * y % P
        if not ok or _is_negative(t) or y == 0:
            return None
        return cls(x, y, 1, t)


IDENTITY = RistrettoPoint(0, 1, 1, 0)

# basepoint: Edwards25519 generator, y = 4/5, x nonnegative
_BY = 4 * pow(5, -1, P) % P
_BX = _sqrt_ratio_i((_BY * _BY - 1) % P, (1 + D * _BY % P * _BY) % P)[1]
BASEPOINT = RistrettoPoint(_BX, _BY, 1, _BX * _BY % P)


class RistrettoGroup:
    """Group-op surface matching WeierstrassGroup (host/curves.py) so the
    DL-schemes (spartan/hyrax/bulletproofs) stay backend-generic."""

    def __init__(self):
        self.order = L
        self.generator = BASEPOINT

    def infinity(self) -> RistrettoPoint:
        return IDENTITY

    def is_on_curve(self, p: RistrettoPoint) -> bool:
        x, y, z, t = p.X % P, p.Y % P, p.Z % P, p.T % P
        if z == 0:
            return False
        ok1 = (y * y - x * x - z * z - D * t % P * t) % P == 0
        ok2 = (x * y - z * t) % P == 0
        return ok1 and ok2

    def add(self, p: RistrettoPoint, q: RistrettoPoint) -> RistrettoPoint:
        """Extended-coordinates unified addition (a = -1): complete."""
        A = (p.Y - p.X) * (q.Y - q.X) % P
        B = (p.Y + p.X) * (q.Y + q.X) % P
        C = p.T * 2 % P * D % P * q.T % P
        Dd = p.Z * 2 % P * q.Z % P
        E = (B - A) % P
        F = (Dd - C) % P
        G = (Dd + C) % P
        H = (B + A) % P
        return RistrettoPoint(E * F % P, G * H % P, F * G % P, E * H % P)

    def double(self, p: RistrettoPoint) -> RistrettoPoint:
        A = p.X * p.X % P
        B = p.Y * p.Y % P
        C = 2 * p.Z % P * p.Z % P
        H = (A + B) % P
        E = (H - (p.X + p.Y) ** 2) % P
        G = (A - B) % P
        F = (C + G) % P
        return RistrettoPoint(E * F % P, G * H % P, F * G % P, E * H % P)

    def neg(self, p: RistrettoPoint) -> RistrettoPoint:
        return RistrettoPoint(P - p.X if p.X else 0, p.Y, p.Z, P - p.T if p.T else 0)

    def sub(self, p: RistrettoPoint, q: RistrettoPoint) -> RistrettoPoint:
        return self.add(p, self.neg(q))

    def mul(self, p: RistrettoPoint, k: int) -> RistrettoPoint:
        k %= L
        acc = IDENTITY
        base = p
        while k:
            if k & 1:
                acc = self.add(acc, base)
            base = self.double(base)
            k >>= 1
        return acc

    def msm(self, points, scalars) -> RistrettoPoint:
        """Pippenger bucket MSM (the reference delegates to dalek's
        vartime_multiscalar_mul, group.rs:29-47)."""
        n = len(points)
        assert n == len(scalars)
        if n == 0:
            return IDENTITY
        c = max(1, n.bit_length() - 1) if n > 16 else 3
        nbits = 253
        windows = range(0, nbits, c)
        acc = IDENTITY
        for w in reversed(list(windows)):
            for _ in range(c):
                acc = self.double(acc)
            buckets = [IDENTITY] * (1 << c)
            for pt, s in zip(points, scalars):
                digit = (int(s) % L >> w) & ((1 << c) - 1)
                if digit:
                    buckets[digit] = self.add(buckets[digit], pt)
            running = IDENTITY
            summed = IDENTITY
            for b in reversed(buckets[1:]):
                running = self.add(running, b)
                summed = self.add(summed, running)
            acc = self.add(acc, summed)
        return acc


@dataclass(frozen=True)
class Curve25519:
    """Registry entry shaped like PairingCurve, minus pairings (the
    reference's ProjectiveCurve impl panics on the unused methods too,
    group.rs:104-130 — here non-pairing usage simply has no such methods)."""

    name: str = "curve25519"

    @property
    def fr(self) -> FieldSpec:
        # GENERATOR = 9 (curve25519/src/fr.rs:65)
        return FieldSpec("curve25519_fr", L, 9)

    @property
    def fq(self) -> FieldSpec:
        return FieldSpec("curve25519_fq", P, 2)

    @property
    def g1(self) -> RistrettoGroup:
        return RistrettoGroup()

    @property
    def g1_gen(self) -> RistrettoPoint:
        return BASEPOINT


def get_curve25519() -> Curve25519:
    return Curve25519()

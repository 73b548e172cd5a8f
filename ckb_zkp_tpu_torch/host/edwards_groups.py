# Copied from ckb_zkp_tpu/host/edwards_groups.py (host ints only): the port keeps its own copy.
"""JubJub and Baby-JubJub twisted Edwards groups (host ints).

The reference advertises "Efficient ECC for zkSNARKs: Jubjub and BabyJubJub"
(ckb-zkp README.md:27) and publishes its bulletproofs verifier
benchmark over four curves including JubJub and Baby_JubJub
(ckb-zkp README.md:283-288); the curve implementations themselves
come from arkworks (`ark-ed-on-bls12-381` / `ark-ed-on-bn254`) behind the
`Curve` trait (curve/src/lib.rs:20-46). Here: a generic complete twisted
Edwards group a*x^2 + y^2 = 1 + d*x^2*y^2 over the host-int field layer,
restricted to the prime-order subgroup, with registry entries shaped like
`Curve25519` (host/ristretto.py) so every DL scheme (bulletproofs, spartan,
hyrax, libra) is backend-generic over them.

Parameters:
- JubJub: base field = BLS12-381 scalar field, a = -1,
  d = -(10240/10241), subgroup order r (cofactor 8) — the zcash JubJub
  curve arkworks packages as `ed_on_bls12_381`.
- Baby-JubJub: base field = BN254 scalar field, a = 168700, d = 168696,
  cofactor 8 (EIP-2494), arkworks `ed_on_bn254`.

Completeness: the affine addition law is complete when `a` is a square and
`d` a non-square in Fq — true for both curves (checked at import).

Serialization follows ark-serialize 0.2's twisted Edwards rules as derived
from the arkworks source (no cargo on this box to emit fixtures — same
self-derived-rule caveat as serialize/ark.py): compressed form is the
y-coordinate in little-endian field bytes with the x-sign flag in the top
bit of the final byte (set iff x > q - x); the identity (0, 1) serializes
as the zero field element with a clear flag, and x is recovered from
x^2 = (y^2 - 1)/(d*y^2 - a).

Generator derivation (deterministic, verified at import): smallest y >= 2
whose curve lift exists, x chosen with the even root, multiplied by the
cofactor to land in the prime-order subgroup; asserts r*G = identity.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from .field import FieldSpec, _tonelli_shanks


@dataclass(frozen=True)
class EdwardsPoint:
    """Affine twisted Edwards point. Identity is (0, 1)."""

    x: int
    y: int

    @property
    def infinity(self) -> bool:  # naming parity with AffinePoint
        return self.x == 0 and self.y == 1


class TwistedEdwardsGroup:
    """Complete-addition twisted Edwards group over Fq (prime subgroup)."""

    def __init__(self, name: str, q: int, a: int, d: int, r: int, cofactor: int):
        self.name = name
        self.q = q
        self.a = a % q
        self.d = d % q
        self.order = r
        self.cofactor = cofactor
        assert pow(self.a, (q - 1) // 2, q) == 1, "a must be a square (completeness)"
        assert pow(self.d, (q - 1) // 2, q) == q - 1, "d must be a non-square"
        self.generator = self._derive_generator()

    # ---- derivation ----
    def _lift(self, y: int) -> EdwardsPoint | None:
        """Point with this y (even x), or None."""
        q, a, d = self.q, self.a, self.d
        den = (d * y * y - a) % q
        if den == 0:
            return None
        xx = (y * y - 1) * pow(den, -1, q) % q
        x = _tonelli_shanks(xx, q)
        if x is None or x * x % q != xx:
            return None
        if x % 2 == 1:
            x = q - x
        return EdwardsPoint(x, y % q)

    def _derive_generator(self) -> EdwardsPoint:
        y = 2
        while True:
            p = self._lift(y)
            if p is not None:
                g = self.mul_unreduced(p, self.cofactor)
                if not g.infinity and self.mul_unreduced(g, self.order).infinity:
                    return g
            y += 1

    # ---- group ops ----
    def infinity(self) -> EdwardsPoint:
        return EdwardsPoint(0, 1)

    def is_on_curve(self, p: EdwardsPoint) -> bool:
        q, a, d = self.q, self.a, self.d
        x, y = p.x % q, p.y % q
        return (a * x * x + y * y) % q == (1 + d * x * x % q * y % q * y) % q

    def add(self, p: EdwardsPoint, r: EdwardsPoint) -> EdwardsPoint:
        q, a, d = self.q, self.a, self.d
        x1, y1, x2, y2 = p.x, p.y, r.x, r.y
        t = d * x1 % q * x2 % q * y1 % q * y2 % q
        x3 = (x1 * y2 + y1 * x2) % q * pow((1 + t) % q, -1, q) % q
        y3 = (y1 * y2 - a * x1 % q * x2) % q * pow((1 - t) % q, -1, q) % q
        return EdwardsPoint(x3, y3)

    def double(self, p: EdwardsPoint) -> EdwardsPoint:
        return self.add(p, p)

    def neg(self, p: EdwardsPoint) -> EdwardsPoint:
        return EdwardsPoint((-p.x) % self.q, p.y)

    def sub(self, p: EdwardsPoint, r: EdwardsPoint) -> EdwardsPoint:
        return self.add(p, self.neg(r))

    def mul_unreduced(self, p: EdwardsPoint, k: int) -> EdwardsPoint:
        acc, base = self.infinity(), p
        while k:
            if k & 1:
                acc = self.add(acc, base)
            base = self.add(base, base)
            k >>= 1
        return acc

    def mul(self, p: EdwardsPoint, k: int) -> EdwardsPoint:
        return self.mul_unreduced(p, k % self.order)

    def msm(self, points, scalars) -> EdwardsPoint:
        """Pippenger bucket MSM (parity: arkworks VariableBaseMSM via the
        Curve trait default, curve/src/lib.rs:38-45)."""
        n = len(points)
        assert n == len(scalars)
        if n == 0:
            return self.infinity()
        c = max(1, n.bit_length() - 1) if n > 16 else 3
        nbits = self.order.bit_length()
        acc = self.infinity()
        for w in reversed(range(0, nbits, c)):
            for _ in range(c):
                acc = self.double(acc)
            buckets = [self.infinity()] * (1 << c)
            for pt, s in zip(points, scalars):
                digit = (int(s) % self.order >> w) & ((1 << c) - 1)
                if digit:
                    buckets[digit] = self.add(buckets[digit], pt)
            running = self.infinity()
            summed = self.infinity()
            for b in reversed(buckets[1:]):
                running = self.add(running, b)
                summed = self.add(summed, running)
            acc = self.add(acc, summed)
        return acc

    # ---- ark-0.2-style compressed encoding (see module docstring) ----
    @property
    def _nbytes(self) -> int:
        n64 = (self.q.bit_length() + 63) // 64
        return n64 * 8

    def point_to_bytes(self, p: EdwardsPoint) -> bytes:
        if p.infinity:
            return bytes(self._nbytes)
        raw = bytearray((p.y % self.q).to_bytes(self._nbytes, "little"))
        if p.x > self.q - p.x:  # x "negative"
            raw[-1] |= 0x80
        return bytes(raw)

    def point_from_bytes(self, raw: bytes) -> EdwardsPoint | None:
        if len(raw) != self._nbytes:
            return None
        buf = bytearray(raw)
        x_neg = bool(buf[-1] & 0x80)
        buf[-1] &= 0x7F
        y = int.from_bytes(bytes(buf), "little")
        if y == 0 and not x_neg:
            return self.infinity()
        if y >= self.q:
            return None
        q, a, d = self.q, self.a, self.d
        den = (d * y * y - a) % q
        if den == 0:
            return None
        xx = (y * y - 1) * pow(den, -1, q) % q
        x = _tonelli_shanks(xx, q)
        if x is None or x * x % q != xx:
            return None
        if (x > q - x) != x_neg:
            x = (q - x) % q
        pt = EdwardsPoint(x, y)
        return pt if self.is_on_curve(pt) else None


def _smallest_non_qr(p: int) -> int:
    g = 2
    while pow(g, (p - 1) // 2, p) != p - 1:
        g += 1
    return g


# subgroup orders (standard published values; r*G = identity asserted at
# group construction)
_JUBJUB_R = 0x0E7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7
_BABYJUB_R = (
    2736030358979909402780800718157159386076813972158567259200215660948447373041
)


@functools.lru_cache(maxsize=None)
def _jubjub_group() -> TwistedEdwardsGroup:
    from .pairing import get_curve

    q = get_curve("bls12_381").fr.modulus
    d = (-10240 * pow(10241, -1, q)) % q
    return TwistedEdwardsGroup("jubjub", q, q - 1, d, _JUBJUB_R, 8)


@functools.lru_cache(maxsize=None)
def _babyjubjub_group() -> TwistedEdwardsGroup:
    from .pairing import get_curve

    q = get_curve("bn254").fr.modulus
    return TwistedEdwardsGroup("baby_jubjub", q, 168700, 168696, _BABYJUB_R, 8)


class _EdwardsRegistry:
    """Registry entry shaped like Curve25519 (host/ristretto.py)."""

    is_edwards = True

    def __init__(self, name: str, group_fn):
        self.name = name
        self._group_fn = group_fn

    @property
    def g1(self) -> TwistedEdwardsGroup:
        return self._group_fn()

    @property
    def g1_gen(self) -> EdwardsPoint:
        return self._group_fn().generator

    @property
    def fr(self) -> FieldSpec:
        g = self._group_fn()
        return FieldSpec(f"{self.name}_fr", g.order, _smallest_non_qr(g.order))

    @property
    def fq(self) -> FieldSpec:
        g = self._group_fn()
        return FieldSpec(f"{self.name}_fq", g.q, _smallest_non_qr(g.q))


def get_jubjub() -> _EdwardsRegistry:
    return _EdwardsRegistry("jubjub", _jubjub_group)


def get_baby_jubjub() -> _EdwardsRegistry:
    return _EdwardsRegistry("baby_jubjub", _babyjubjub_group)


def get_edwards_curve(name: str):
    name = name.lower().replace("-", "_")
    if name == "jubjub":
        return get_jubjub()
    if name in ("baby_jubjub", "babyjubjub"):
        return get_baby_jubjub()
    raise KeyError(f"unknown edwards curve {name!r}")

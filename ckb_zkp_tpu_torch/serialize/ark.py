# Copied from ckb_zkp_tpu/serialize/ark.py (host ints and numpy only): the port keeps its own copy.
"""Field/point codecs in the arkworks-0.2 wire format."""

from __future__ import annotations

import io

from ..host.curves import AffinePoint, WeierstrassGroup
from ..host.field import FieldSpec
from ..host.pairing import PairingCurve
from ..host.tower import Tower

FLAG_INFINITY = 1 << 6
FLAG_POSITIVE_Y = 1 << 7


def write_u64(buf: io.BytesIO, n: int) -> None:
    buf.write(int(n).to_bytes(8, "little"))


def read_u64(buf: io.BytesIO) -> int:
    return int.from_bytes(buf.read(8), "little")


class FieldCodec:
    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.nbytes = spec.nbytes

    def to_bytes(self, x: int, flags: int = 0) -> bytes:
        raw = bytearray((x % self.spec.modulus).to_bytes(self.nbytes, "little"))
        raw[-1] |= flags
        return bytes(raw)

    def from_bytes(self, data: bytes, with_flags: bool = False):
        raw = bytearray(data)
        flags = raw[-1] & 0xC0
        if with_flags:
            raw[-1] &= 0x3F
        x = int.from_bytes(bytes(raw), "little")
        if x >= self.spec.modulus:
            raise ValueError("non-canonical field element")
        return (x, flags) if with_flags else x

    def read(self, buf: io.BytesIO, with_flags: bool = False):
        data = buf.read(self.nbytes)
        if len(data) != self.nbytes:
            raise ValueError("truncated field element")
        return self.from_bytes(data, with_flags)


def _fq2_sqrt(tower: Tower, a):
    """Square root in Fq2 (q = 3 mod 4), or None."""
    q = tower.q
    a0, a1 = a
    if a1 == 0:
        r = _fq_sqrt(q, a0)
        if r is not None:
            return (r, 0)
        # sqrt of non-residue a0: a0 = -(x^2) form -> root is x*u
        r = _fq_sqrt(q, -a0 % q)
        return None if r is None else (0, r)
    norm = (a0 * a0 + a1 * a1) % q
    n = _fq_sqrt(q, norm)
    if n is None:
        return None
    for sign in (1, -1):
        half = (a0 + sign * n) * pow(2, -1, q) % q
        x = _fq_sqrt(q, half)
        if x is not None and x != 0:
            y = a1 * pow(2 * x, -1, q) % q
            if tower.f2_sqr((x, y)) == (a0 % q, a1 % q):
                return (x, y)
    return None


def _fq_sqrt(q: int, a: int):
    from ..host.field import _tonelli_shanks

    return _tonelli_shanks(a, q)


class _PointCodec:
    """Shared logic for G1 (Fq coords) and G2 (Fq2 coords)."""

    def __init__(self, curve: PairingCurve):
        self.curve = curve
        self.fq = FieldCodec(curve.fq)

    # subclass hooks -------------------------------------------------
    group: WeierstrassGroup

    def _coord_bytes(self, c, flags: int) -> bytes: ...
    def _coord_read(self, buf): ...  # -> (coord, flags)
    def _neg(self, y): ...
    def _is_positive(self, y) -> bool: ...
    def _zero_coord(self): ...
    def _sqrt_rhs(self, x): ...

    @property
    def compressed_size(self) -> int:
        return len(self.to_bytes(self.group.infinity))

    def to_bytes(self, p: AffinePoint) -> bytes:
        if p.infinity:
            return self._coord_bytes(self._zero_coord(), FLAG_INFINITY)
        flags = FLAG_POSITIVE_Y if self._is_positive(p.y) else 0
        return self._coord_bytes(p.x, flags)

    def to_bytes_uncompressed(self, p: AffinePoint) -> bytes:
        if p.infinity:
            z = self._zero_coord()
            return self._coord_bytes(z, 0) + self._coord_bytes(z, FLAG_INFINITY)
        return self._coord_bytes(p.x, 0) + self._coord_bytes(p.y, 0)

    def read(self, buf: io.BytesIO, check: bool = True) -> AffinePoint:
        x, flags = self._coord_read(buf)
        if flags & FLAG_INFINITY:
            return self.group.infinity
        y = self._sqrt_rhs(x)
        if y is None:
            raise ValueError("x not on curve")
        want_pos = bool(flags & FLAG_POSITIVE_Y)
        if self._is_positive(y) != want_pos:
            y = self._neg(y)
        p = AffinePoint(x, y)
        if check and not self.group.is_on_curve(p):
            raise ValueError("point not on curve")
        return p

    def read_uncompressed(self, buf: io.BytesIO, check: bool = True) -> AffinePoint:
        x, _ = self._coord_read(buf)
        y, flags = self._coord_read(buf)
        if flags & FLAG_INFINITY:
            return self.group.infinity
        p = AffinePoint(x, y)
        if check and not self.group.is_on_curve(p):
            raise ValueError("point not on curve")
        return p


class G1Codec(_PointCodec):
    def __init__(self, curve: PairingCurve):
        super().__init__(curve)
        self.group = curve.g1

    def _coord_bytes(self, c, flags):
        return self.fq.to_bytes(c, flags)

    def _coord_read(self, buf):
        return self.fq.read(buf, with_flags=True)

    def _neg(self, y):
        return -y % self.curve.fq.modulus

    def _is_positive(self, y):
        return y > self.curve.fq.modulus - y

    def _zero_coord(self):
        return 0

    def _sqrt_rhs(self, x):
        q = self.curve.fq.modulus
        rhs = (x * x * x + self.curve.g1.b) % q
        return _fq_sqrt(q, rhs)


class G2Codec(_PointCodec):
    def __init__(self, curve: PairingCurve):
        super().__init__(curve)
        self.group = curve.g2
        self.tower = curve.tower

    def _coord_bytes(self, c, flags):
        return self.fq.to_bytes(c[0], 0) + self.fq.to_bytes(c[1], flags)

    def _coord_read(self, buf):
        c0 = self.fq.read(buf)
        c1, flags = self.fq.read(buf, with_flags=True)
        return (c0, c1), flags

    def _neg(self, y):
        return self.tower.f2_neg(y)

    def _is_positive(self, y):
        # ark 0.2 QuadExtField ordering: compare c1 first, then c0
        q = self.curve.fq.modulus
        ny = self.tower.f2_neg(y)
        return (y[1], y[0]) > (ny[1], ny[0])

    def _zero_coord(self):
        return (0, 0)

    def _sqrt_rhs(self, x):
        t = self.tower
        rhs = t.f2_add(t.f2_mul(t.f2_sqr(x), x), self.curve.g2.b)
        return _fq2_sqrt(t, rhs)

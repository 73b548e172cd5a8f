# Copied from ckb_zkp_tpu/serialize/struct_codec.py (host ints only) but `_resolve_qualname`, which imports nothing here.
"""Self-describing structured codec for scheme keys/proofs.

The reference derives `CanonicalSerialize` on every key/proof struct; groth16
artifacts here are bit-exact ark-0.2 (serialize/ark.py). For the other
schemes this framework uses a deterministic, *safe* tagged format (no pickle:
contract verifiers consume adversarial bytes) covering the value shapes the
proof dataclasses use: ints, curve points (G1/G2/ristretto), None, bytes,
lists/tuples/dicts, and registered dataclasses by name.

Layout: 1 tag byte, then
  I: 2-byte length + unsigned LE int        N: (nothing)
  F: false / T: true                        B: 4-byte length + raw bytes
  L/U: 4-byte count + items (list / tuple)  M: 4-byte count + key/value pairs
  P: curve point (ristretto: 32 bytes; pairing: group byte + x||y||inf)
  D: registered dataclass — 1-byte name length + name + field values in order
"""

from __future__ import annotations

import dataclasses
import struct

from ..host.curves import AffinePoint
from ..host.edwards_groups import EdwardsPoint
from ..host.ristretto import RistrettoPoint

_REGISTRY: dict[str, type] = {}


def _is_curve(v) -> bool:
    from ..host.edwards_groups import _EdwardsRegistry
    from ..host.pairing import PairingCurve
    from ..host.ristretto import Curve25519

    return isinstance(v, (PairingCurve, Curve25519, _EdwardsRegistry))


def _curve_by_name(name: str):
    if name == "curve25519":
        from ..host.ristretto import Curve25519

        return Curve25519()
    if name in ("jubjub", "baby_jubjub"):
        from ..host.edwards_groups import get_edwards_curve

        return get_edwards_curve(name)
    from ..host.pairing import get_curve

    return get_curve(name)


def _resolve_qualname(name: str):
    """No self-registering decode in the port: the original imports a module
    of the JAX package named in the bytes, and cell bytes are adversarial.
    Only registered dataclasses decode; any other name is refused."""
    return None


def register_module(mod) -> None:
    """Register every dataclass defined in a module (for decode)."""
    import inspect

    for _, obj in inspect.getmembers(mod, inspect.isclass):
        if dataclasses.is_dataclass(obj):
            register(obj)


def _qualname(cls) -> str:
    """Registry key: module-qualified (bare `Proof`/`VerifierKey` names
    collide across schemes)."""
    return f"{cls.__module__}:{cls.__name__}"


def register(cls):
    """Class decorator / call: allow a dataclass in the codec."""
    _REGISTRY[_qualname(cls)] = cls
    return cls


def register_all(*classes):
    for c in classes:
        register(c)


class DecodeError(ValueError):
    pass


class _Writer:
    def __init__(self, curve):
        self.curve = curve
        self.parts: list[bytes] = []

    def value(self, v):
        p = self.parts
        if v is None:
            p.append(b"N")
        elif v is True:
            p.append(b"T")
        elif v is False:
            p.append(b"F")
        elif isinstance(v, int):
            raw = int(v).to_bytes((max(v.bit_length(), 1) + 7) // 8, "little", signed=False) if v >= 0 else None
            if raw is None:
                raise DecodeError("negative ints are not in any proof format")
            p.append(b"I" + struct.pack("<H", len(raw)) + raw)
        elif isinstance(v, bytes):
            p.append(b"B" + struct.pack("<I", len(v)) + v)
        elif isinstance(v, str):
            raw = v.encode()
            p.append(b"S" + struct.pack("<H", len(raw)) + raw)
        elif _is_curve(v):
            nb = v.name.encode()
            p.append(b"C" + bytes([len(nb)]) + nb)
        elif isinstance(v, RistrettoPoint):
            p.append(b"P" + b"r" + v.encode())
        elif isinstance(v, EdwardsPoint):
            fq = self.curve.fq
            coords = (v.x % fq.modulus).to_bytes(fq.nbytes, "little") + (
                v.y % fq.modulus
            ).to_bytes(fq.nbytes, "little")
            p.append(b"P" + b"e" + coords)
        elif isinstance(v, AffinePoint):
            fq = self.curve.fq
            if isinstance(v.x, int):
                coords = (v.x % fq.modulus).to_bytes(fq.nbytes, "little") + (
                    v.y % fq.modulus
                ).to_bytes(fq.nbytes, "little")
                p.append(b"P" + b"1" + coords + bytes([1 if v.infinity else 0]))
            else:
                coords = b"".join(
                    (c % fq.modulus).to_bytes(fq.nbytes, "little")
                    for c in (*v.x, *v.y)
                )
                p.append(b"P" + b"2" + coords + bytes([1 if v.infinity else 0]))
        elif isinstance(v, list):
            p.append(b"L" + struct.pack("<I", len(v)))
            for item in v:
                self.value(item)
        elif isinstance(v, tuple):
            p.append(b"U" + struct.pack("<I", len(v)))
            for item in v:
                self.value(item)
        elif isinstance(v, dict):
            p.append(b"M" + struct.pack("<I", len(v)))
            for k in v:
                self.value(k)
                self.value(v[k])
        elif dataclasses.is_dataclass(v):
            name = _qualname(type(v))
            if name not in _REGISTRY:
                register(type(v))
            nb = name.encode()
            assert len(nb) < 256
            p.append(b"D" + bytes([len(nb)]) + nb)
            for f in dataclasses.fields(v):
                self.value(getattr(v, f.name))
        else:
            raise DecodeError(f"unsupported type {type(v)!r}")


class _Reader:
    def __init__(self, curve, data: bytes):
        self.curve = curve
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise DecodeError("truncated")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def value(self):
        tag = self._take(1)
        if tag == b"N":
            return None
        if tag == b"T":
            return True
        if tag == b"F":
            return False
        if tag == b"I":
            (ln,) = struct.unpack("<H", self._take(2))
            return int.from_bytes(self._take(ln), "little")
        if tag == b"B":
            (ln,) = struct.unpack("<I", self._take(4))
            return self._take(ln)
        if tag == b"S":
            (ln,) = struct.unpack("<H", self._take(2))
            return self._take(ln).decode()
        if tag == b"C":
            (ln,) = struct.unpack("<B", self._take(1))
            return _curve_by_name(self._take(ln).decode())
        if tag == b"P":
            grp = self._take(1)
            if grp == b"r":
                pt = RistrettoPoint.decode(self._take(32))
                if pt is None:
                    raise DecodeError("invalid ristretto encoding")
                return pt
            if grp == b"e":
                fq = self.curve.fq
                nb = fq.nbytes
                x = int.from_bytes(self._take(nb), "little")
                y = int.from_bytes(self._take(nb), "little")
                if x >= fq.modulus or y >= fq.modulus:
                    raise DecodeError("coordinate out of range")
                pt = EdwardsPoint(x, y)
                if not self.curve.g1.is_on_curve(pt):
                    raise DecodeError("point not on edwards curve")
                return pt
            fq = self.curve.fq
            nb = fq.nbytes
            if grp == b"1":
                x = int.from_bytes(self._take(nb), "little")
                y = int.from_bytes(self._take(nb), "little")
                inf = self._take(1) != b"\x00"
                if x >= fq.modulus or y >= fq.modulus:
                    raise DecodeError("coordinate out of range")
                return AffinePoint(x, y, inf)
            if grp == b"2":
                c = [int.from_bytes(self._take(nb), "little") for _ in range(4)]
                if any(v >= fq.modulus for v in c):
                    raise DecodeError("coordinate out of range")
                inf = self._take(1) != b"\x00"
                return AffinePoint((c[0], c[1]), (c[2], c[3]), inf)
            raise DecodeError("unknown point group")
        if tag in (b"L", b"U"):
            (n,) = struct.unpack("<I", self._take(4))
            if n > len(self.data):  # cheap bomb guard
                raise DecodeError("length exceeds payload")
            items = [self.value() for _ in range(n)]
            return items if tag == b"L" else tuple(items)
        if tag == b"M":
            (n,) = struct.unpack("<I", self._take(4))
            if n > len(self.data):
                raise DecodeError("length exceeds payload")
            return {self.value(): self.value() for _ in range(n)}
        if tag == b"D":
            (ln,) = struct.unpack("<B", self._take(1))
            name = self._take(ln).decode()
            cls = _REGISTRY.get(name)
            if cls is None:
                cls = _resolve_qualname(name)
            if cls is None:
                raise DecodeError(f"unknown dataclass {name!r}")
            args = [self.value() for _ in dataclasses.fields(cls)]
            return cls(*args)
        raise DecodeError(f"unknown tag {tag!r}")


def encode(curve, value) -> bytes:
    w = _Writer(curve)
    w.value(value)
    return b"".join(w.parts)


def decode(curve, data: bytes):
    r = _Reader(curve, data)
    out = r.value()
    if r.pos != len(data):
        raise DecodeError("trailing bytes")
    return out

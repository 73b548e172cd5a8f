# Copied from ckb_zkp_tpu/serialize/tobytes.py (host ints only): the port keeps its own copy.
"""ark `ToBytes`-style encodings (transcript/Fiat-Shamir absorbs).

Distinct from CanonicalSerialize: affine points write x || y || infinity-u8
with no compression flags; Option<T> writes a presence byte. Used by the
merlin transcripts (bulletproofs et al.) and marlin/plonk FS-RNG seeds.
"""

from __future__ import annotations

from ..host.curves import AffinePoint
from ..host.pairing import PairingCurve


def u64_bytes(x: int) -> bytes:
    return int(x).to_bytes(8, "little")


def fr_bytes(curve: PairingCurve, x: int) -> bytes:
    return (x % curve.fr.modulus).to_bytes(curve.fr.nbytes, "little")


def frs_bytes(curve: PairingCurve, xs) -> bytes:
    return b"".join(fr_bytes(curve, x) for x in xs)


def fq_bytes(curve: PairingCurve, x: int) -> bytes:
    return (x % curve.fq.modulus).to_bytes(curve.fq.nbytes, "little")


def point_bytes(curve: PairingCurve, pt, group: str = "g1") -> bytes:
    if curve.name == "curve25519":
        # ristretto: 32-byte compressed encoding (curve25519/src/group.rs:293-338)
        return pt.encode()
    if group == "g1":
        coords = fq_bytes(curve, pt.x) + fq_bytes(curve, pt.y)
    else:
        coords = (
            fq_bytes(curve, pt.x[0])
            + fq_bytes(curve, pt.x[1])
            + fq_bytes(curve, pt.y[0])
            + fq_bytes(curve, pt.y[1])
        )
    return coords + bytes([1 if pt.infinity else 0])


def points_bytes(curve: PairingCurve, pts, group: str = "g1") -> bytes:
    return b"".join(point_bytes(curve, pt, group) for pt in pts)


def option_bytes(inner: bytes | None) -> bytes:
    return (b"\x01" + inner) if inner is not None else b"\x00"

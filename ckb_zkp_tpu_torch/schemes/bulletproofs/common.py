# Copied from ckb_zkp_tpu/schemes/bulletproofs/common.py (host ints only): the port keeps its own copy.
"""Shared helpers: vector algebra, transcript byte encodings, VecPoly5.

Parity: ckb-zkp bulletproofs/src/lib.rs:37-317. Vector math is over
host ints (protocol-layer sizes); generator MSMs (A_I/A_O/S, the IPP_P
commitment and the IPA round L/R points) route through the device Pippenger
above the size threshold (ops/msm.msm_over_fixed_base).
"""

from __future__ import annotations

from ...host.curves import AffinePoint
from ...host.pairing import PairingCurve


def random_bytes_to_fr(p: int, data: bytes) -> int:
    """31 LE bytes -> Fr (mirrors lib.rs:310-317 from_random_bytes trick)."""
    return int.from_bytes(data, "little") % p


def fr_bytes(curve: PairingCurve, x: int) -> bytes:
    """ark `to_bytes!` for a field element: canonical LE, fixed width."""
    return (x % curve.fr.modulus).to_bytes(curve.fr.nbytes, "little")


def point_bytes(curve: PairingCurve, pt, group: str = "g1") -> bytes:
    """ark `to_bytes!` for an affine point: x || y || infinity-u8."""
    if curve.name == "curve25519":
        return pt.encode()  # 32-byte ristretto compression
    if getattr(curve, "is_edwards", False):
        # ark ToBytes for a twisted Edwards affine: x || y (identity is the
        # valid affine (0, 1) — no infinity byte)
        nb = curve.fq.nbytes
        q = curve.fq.modulus
        return (pt.x % q).to_bytes(nb, "little") + (pt.y % q).to_bytes(
            nb, "little"
        )
    fq = curve.fq
    if group == "g1":
        x = (pt.x % fq.modulus).to_bytes(fq.nbytes, "little")
        y = (pt.y % fq.modulus).to_bytes(fq.nbytes, "little")
    else:
        x = (pt.x[0] % fq.modulus).to_bytes(fq.nbytes, "little") + (
            pt.x[1] % fq.modulus
        ).to_bytes(fq.nbytes, "little")
        y = (pt.y[0] % fq.modulus).to_bytes(fq.nbytes, "little") + (
            pt.y[1] % fq.modulus
        ).to_bytes(fq.nbytes, "little")
    return x + y + bytes([1 if pt.infinity else 0])


def points_bytes(curve: PairingCurve, pts, group: str = "g1") -> bytes:
    return b"".join(point_bytes(curve, pt, group) for pt in pts)


def frs_bytes(curve: PairingCurve, xs) -> bytes:
    return b"".join(fr_bytes(curve, x) for x in xs)


# ---------------- vector algebra over Fr (host ints) ----------------
def inner_product(a: list[int], b: list[int], p: int) -> int:
    return sum(x * y % p for x, y in zip(a, b)) % p


def hadamard(a: list[int], b: list[int], p: int) -> list[int]:
    return [x * y % p for x, y in zip(a, b)]


def vec_add(a: list[int], b: list[int], p: int) -> list[int]:
    return [(x + y) % p for x, y in zip(a, b)]


def scalar_powers(x: int, n: int, p: int, start_one: bool = True) -> list[int]:
    out = []
    cur = 1 if start_one else x
    for _ in range(n):
        out.append(cur)
        cur = cur * x % p
    return out


class VecPoly5:
    """Vector polynomial with coefficient vectors at degrees 0..5.

    Parity: lib.rs VecPoly5 — l uses degrees 2,3,4,5; r uses 0,1,2,5.
    """

    def __init__(self, n: int, p: int):
        self.n = n
        self.p = p
        self.coeffs = [[0] * n for _ in range(6)]

    def eval(self, x: int) -> list[int]:
        p = self.p
        out = [0] * self.n
        xp = 1
        for d in range(6):
            cd = self.coeffs[d]
            for i in range(self.n):
                if cd[i]:
                    out[i] = (out[i] + cd[i] * xp) % p
            xp = xp * x % p
        return out

    @staticmethod
    def special_inner_product(l: "VecPoly5", r: "VecPoly5") -> dict[int, int]:
        """t(X) = <l(X), r(X)>: coefficients t_0..t_10."""
        p = l.p
        t = {}
        for dl in range(6):
            for dr in range(6):
                c = inner_product(l.coeffs[dl], r.coeffs[dr], p)
                if c:
                    t[dl + dr] = (t.get(dl + dr, 0) + c) % p
        return t

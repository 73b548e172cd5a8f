"""Pippenger MSM over the ristretto255 group (curve25519) on torch.

Port of the reference's `ops/ristretto_device.py`: the windowed Pippenger
of `DeviceCurveGroup` (`msm.py`, its generic branch, `_affine_leaves`
False) over the twisted-Edwards point operations of `edwards.py`. Points
are extended (X, Y, Z, T) tuples of Montgomery limbs over Fq = 2^255 - 19;
scalars are canonical limbs of Fr = l, the group order; both fields have
16 limbs, so every product is K1's 8-word instance. Results are projective
representatives: compare them by the host group's equality or by their
encoding (`host/ristretto.py`), never coordinate by coordinate.

The reference's device window table (`_table_impl`) has no caller in any
scheme and is not ported: `fixed_base_table` raises.
"""

from __future__ import annotations

import functools

import torch

from ..host import ristretto as rhost
from ..host.ristretto import Curve25519, RistrettoPoint
from .edwards import ed_add, ed_double, ed_identity, ed_neg
from .field import device_field
from .limbs import BASE_BITS
from .msm import DeviceCurveGroup


class DeviceRistrettoGroup(DeviceCurveGroup):
    """Pippenger over extended-Edwards (X, Y, Z, T) points on `device`:
    `DeviceCurveGroup`'s generic window sums and fold through the group's
    own p_add/p_double/p_neg/p_identity."""

    _affine_leaves = False
    _use_rcb = False

    def __init__(self, curve: Curve25519, window_bits: int = 8, device="cuda"):
        # the reference's own constructor (`ops/ristretto_device.py:36-56`):
        # the parent's reads a Weierstrass host group
        if window_bits not in (1, 2, 4, 8, 16):
            raise ValueError(f"window_bits {window_bits}: windows must not straddle limbs")
        self.curve = curve
        self.group = "ristretto"
        self.device = torch.device(device)
        self.c = window_bits
        self.nb = 1 << window_bits
        self.fq = device_field(curve.fq, device)  # 2^255 - 19
        self.fr = device_field(curve.fr, device)  # the group order l
        self.cf = self.fq
        self.host_group = curve.g1
        self.nwindows = self.fr.L * BASE_BITS // self.c
        self._d2 = self.fq.const(2 * rhost.D % rhost.P)

    def _normalize(self, P):
        # extended (X, Y, Z, T): any Z serves downstream
        return P

    def fixed_base_table(self, base_affine):
        raise NotImplementedError(
            "the Ristretto group has no device window table in the port (no scheme uses one)")

    # ------------- point ops (twisted Edwards, a = -1) -------------
    def p_add(self, a, b):
        return ed_add(self.fq, self._d2, a, b)

    def p_double(self, a):
        return ed_double(self.fq, a)

    def p_neg(self, a):
        return ed_neg(self.fq, a)

    def p_identity(self, batch_shape=()):
        return ed_identity(self.fq, batch_shape)

    # ------------- host <-> device -------------
    def encode_points(self, pts: list[RistrettoPoint]):
        """Host extended points -> (X, Y, Z, T) Montgomery limb tensors."""
        P = rhost.P
        return tuple(self.fq.encode([getattr(pt, k) % P for pt in pts]) for k in "XYZT")

    def decode_points_host(self, p) -> list[RistrettoPoint]:
        """(X, Y, Z, T) tensors -> host points, projective as they are (the
        host RistrettoPoint compares and encodes projectively: no
        inversion)."""
        X, Y, Z, T = (self.fq.decode(c) for c in p)
        return [RistrettoPoint(*v) for v in zip(X, Y, Z, T)]

    def decode_points(self, p) -> list[RistrettoPoint]:
        return self.decode_points_host(p)


@functools.lru_cache(maxsize=None)
def _device_ristretto_group(window_bits: int, device: str) -> DeviceRistrettoGroup:
    return DeviceRistrettoGroup(Curve25519(), window_bits, device)


def device_ristretto_group(window_bits: int = 8, device="cuda") -> DeviceRistrettoGroup:
    """The cached group of (window_bits, device); "cuda" names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _device_ristretto_group(window_bits, str(dev))

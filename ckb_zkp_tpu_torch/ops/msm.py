"""Pippenger multi-scalar multiplication and fixed-base MSM on torch.

Port of the reference's `ops/msm.py` `DeviceCurveGroup` for G1 (over Fq)
and G2 (over Fq2): point/scalar encoding (`:431-536`), `msm` (`:539-586`)
with the RCB Pippenger `_msm_rcb` (`:741-814`), and the setup's
`fixed_base_msm` (`:982-1045`, K6 per window as `_fixed_base_rcb`,
`:901-955`) with its host-built window table (`:1047`).

Per window the MSM sorts the points by digit, runs K2 over the sorted
packed affine leaves (every within-block prefix W and block totals T),
forms the bucket-boundary prefixes E_b = prefix(T, g_b - 1) + W[q_b]
(K3 levels, a Hillis-Steele top and K5), and telescopes the bucket
weighting to (2^c - 1) E_last - sum_{b < nb-1} E_b (K4 levels and a B = n
tail). Unlike the reference, which runs windows one at a time under
lax.scan, the port runs a batch of windows in every launch: the scans then
cover batch * N / 32 columns, which widens the small per-window grid of
the scan kernel, and the launch count per MSM drops by the batch size.
Batches are capped at 2^21 points to bound memory.
"""

from __future__ import annotations

import torch

from ..host.curves import AffinePoint
from .cuda_rcb import pack_limbs_flag, scan_prefix_add, scan_prefix_madd, scan_total_add
from .ec import DeviceFq2, point_select
from .field import device_field
from .limbs import BASE_BITS, ints_to_limbs, limbs_to_ints
from .rcb import RcbGroup
from .scan_utils import hs_scan
from .sparse import COL_ALIGN

_RCB_B = 32  # scan block: elements per sequential accumulation
_SMALL_SCAN_MAX = 32  # _reduce_pts finishes with one B = n launch below this
_TOP_MAX = 128  # _boundary_before finishes with a Hillis-Steele scan below this
_WINDOW_BATCH_POINTS = 1 << 21
_FIXED_BASE_BITS = 8  # fixed-base windows (the reference's device_group default)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad_dim1(pts, n_to: int, ident):
    """Pad (k, n, ...) coordinates along dim 1 with the identity."""
    n = pts[0].shape[1]
    if n == n_to:
        return tuple(pts)
    k = pts[0].shape[0]
    return tuple(
        torch.cat([c, i.expand(k, n_to - n, *i.shape).to(c.dtype)], dim=1)
        for c, i in zip(pts, ident)
    )


def _flat(pts):
    return tuple(c.reshape(-1, *c.shape[2:]) for c in pts)


def _unflat(pts, k: int):
    return tuple(c.reshape(k, -1, *c.shape[1:]) for c in pts)


def _take(pts, rows, idx):
    return tuple(c[rows, idx] for c in pts)


def _boundary_before(rg, T, j, ident_q):
    """Inclusive prefix of the (k, G) block totals T at indices j (k, Q)
    (j = -1 gives the identity), without the full prefix array: each K3
    level yields within-block prefixes and the next level's totals; the
    top (<= 128 points) is a Hillis-Steele scan. Reference:
    `_boundary_before` (`ops/msm.py:216-261`)."""
    B = _RCB_B
    k = T[0].shape[0]
    ident = rg.identity(())
    levels = []
    pts = tuple(T)
    n = pts[0].shape[1]
    while n > _TOP_MAX:
        npad = _cdiv(n, B) * B
        W, Tn = scan_prefix_add(rg, _flat(_pad_dim1(pts, npad, ident)), B)
        g_real = _cdiv(n, B)
        levels.append((tuple(c[:, :n] for c in _unflat(W, k)), n))
        pts = tuple(c[:, :g_real] for c in _unflat(Tn, k))
        n = g_real
    top_pref = hs_scan(rg.add, pts, dim=1)
    rows = torch.arange(k, device=j.device).unsqueeze(1)
    out = None
    q = j
    for W, nl in levels:
        valid = q >= 0
        w = point_select(rg.cf, valid, _take(W, rows, q.clamp(0, nl - 1)), ident_q)
        out = w if out is None else rg.add(out, w)
        q = torch.where(valid, torch.div(q, B, rounding_mode="floor") - 1, -1)
    valid = q >= 0
    top = point_select(rg.cf, valid, _take(top_pref, rows, q.clamp(0, n - 1)), ident_q)
    return top if out is None else rg.add(out, top)


def _reduce_pts(rg, pts):
    """Sum over dim 1 of (k, n) projective points -> (k,): K4 levels, then
    one B = n launch (reference `_reduce_pts`, `ops/msm.py:264-286`)."""
    B = _RCB_B
    k = pts[0].shape[0]
    ident = rg.identity(())
    n = pts[0].shape[1]
    while n > _SMALL_SCAN_MAX:
        npad = _cdiv(n, B) * B
        T = scan_total_add(rg, _flat(_pad_dim1(pts, npad, ident)), B)
        n = _cdiv(n, B)
        pts = tuple(c[:, :n] for c in _unflat(T, k))
    if n == 1:
        return tuple(c[:, 0] for c in pts)
    return scan_total_add(rg, _flat(pts), n)


def _scale_pow2_minus1(rg, p, c: int):
    """(2^c - 1) * p (reference `ops/msm.py:289`). It doubles, here and in
    the window fold, with the complete add t + t: one K5 launch on the
    card, where the torch composition of Alg. 9 (`rg.double`) is a few
    hundred launches of tiny ops at these batches (<= the window count).
    The same point as rg.double, another projective representative."""
    t = p
    for _ in range(c):
        t = rg.add(t, t)
    return rg.add(t, rg.neg(p))


class DeviceCurveGroup:
    """Torch view of one curve group (G1 over Fq, or G2 over Fq2)."""

    def __init__(self, curve, group: str, device="cuda"):
        self.curve = curve
        self.group = group
        self.device = torch.device(device)
        self.fq = device_field(curve.fq, device)
        self.fr = device_field(curve.fr, device)
        if group == "g1":
            self.cf = self.fq
            self.host_group = curve.g1
        elif group == "g2":
            self.cf = DeviceFq2(self.fq)
            self.host_group = curve.g2
        else:
            raise ValueError(group)
        self.c = _FIXED_BASE_BITS
        self.nb = 1 << self.c
        self.nwindows = self.fr.L * BASE_BITS // self.c
        self.rg = RcbGroup(self.cf, self.host_group.b)

    # ------------- host <-> device -------------
    def _coord_encode(self, coords) -> torch.Tensor:
        if self.group == "g1":
            return self.fq.encode(coords)
        flat = [c for pair in coords for c in pair]
        return self.fq.encode(flat).reshape(len(coords), 2, self.fq.L)

    def encode_points(self, pts):
        """Affine host points -> affine-encoded Jacobian (Z = one, or 0 at
        infinity)."""
        xs = self._coord_encode([p.x for p in pts])
        ys = self._coord_encode([p.y for p in pts])
        inf = torch.tensor([p.infinity for p in pts], dtype=torch.bool,
                           device=self.device)
        Z = self.cf.ones((len(pts),))
        Z[inf] = 0
        return (xs, ys, Z)

    def encode_scalars(self, scalars) -> torch.Tensor:
        """Canonical (non-Montgomery) Fr limbs for digit extraction."""
        r = self.fr.spec.modulus
        arr = ints_to_limbs([s % r for s in scalars], self.fr.L)
        return torch.as_tensor(arr.astype("int32"), device=self.device)

    def _coords_host(self, c) -> list:
        p = self.fq.spec.modulus
        rinv = pow(self.fq.R, -1, p)
        vals = [v * rinv % p for v in limbs_to_ints(c.reshape(-1, self.fq.L))]
        if self.group == "g1":
            return vals
        return list(zip(vals[0::2], vals[1::2]))

    def decode_points_host(self, P) -> list:
        """Jacobian (X, Y, Z) arrays -> host affine points, in Python ints."""
        X, Y, Z = (self._coords_host(c) for c in P)
        host = self.host_group
        f = host.f
        out = []
        for x, y, z in zip(X, Y, Z):
            if z == f.zero:
                out.append(host.infinity)
                continue
            zinv = f.inv(z)
            zinv2 = f.mul(zinv, zinv)
            out.append(AffinePoint(f.mul(x, zinv2), f.mul(y, f.mul(zinv, zinv2))))
        return out

    def decode_point(self, p):
        return self.decode_points_host(tuple(c.unsqueeze(0) for c in p))[0]

    # ------------- variable-base Pippenger -------------
    def msm(self, P, scalars):
        """Jacobian point sum_i s_i P_i. P affine-encoded (Z in {0, one});
        scalars (N, L) canonical. Points padded wider than the scalars (the
        reference's pow2-padded G2 query arrays) get zero-extended scalars."""
        n_pts = P[0].shape[0]
        n = scalars.shape[0]
        if n_pts > n:
            scalars = torch.cat([scalars, scalars.new_zeros((n_pts - n, scalars.shape[1]))])
        elif n_pts < n:
            raise ValueError(f"msm: {n_pts} points for {n} scalars")
        return self._msm_rcb(P, scalars)

    @staticmethod
    def _msm_window_bits(n: int) -> int:
        """16-bit windows (digit == one scalar limb) once the 2^16-bucket
        machinery amortizes, 8-bit below (reference `ops/msm.py:736-739`)."""
        return 16 if n >= (1 << 18) else 8

    def _msm_rcb(self, P, scalars):
        rg, cf = self.rg, self.cf
        n = scalars.shape[0]
        c = self._msm_window_bits(n)
        nwin = self.fr.L * BASE_BITS // c
        X, Y, Z = P
        inf = cf.is_zero(Z)
        npad = _cdiv(n, _RCB_B) * _RCB_B
        if npad != n:
            extra = npad - n
            X = torch.cat([X, X.new_zeros((extra, *X.shape[1:]))])
            Y = torch.cat([Y, Y.new_zeros((extra, *Y.shape[1:]))])
            inf = torch.cat([inf, inf.new_ones((extra,))])
            scalars = torch.cat([scalars, scalars.new_zeros((extra, scalars.shape[1]))])
        Xp, Yp = pack_limbs_flag(rg, X, Y, inf)
        bitpos = torch.arange(nwin, device=scalars.device) * c
        limbs = scalars.to(torch.int64)[:, bitpos // BASE_BITS]
        digits = ((limbs >> (bitpos % BASE_BITS)) & ((1 << c) - 1)).T.contiguous()
        batch = max(1, min(nwin, _WINDOW_BATCH_POINTS // npad))
        parts = [
            self._windows(Xp, Yp, digits[w0 : w0 + batch], c)
            for w0 in range(0, nwin, batch)
        ]
        S = tuple(torch.cat(cs, dim=0) for cs in zip(*parts))  # (nwin,)
        acc = rg.identity(())
        for i in range(nwin):
            for _ in range(c):
                acc = rg.add(acc, acc)
            acc = rg.add(acc, tuple(s[nwin - 1 - i] for s in S))
        return rg.to_jacobian(acc)

    def _windows(self, Xp, Yp, digits, c: int):
        """Window sums sum_b b * B_b for a (k, npad) batch of digit rows."""
        rg, cf = self.rg, self.cf
        B = _RCB_B
        k, npad = digits.shape
        nb = 1 << c
        dev = digits.device
        order = torch.sort(digits, dim=1).indices
        xs = Xp[order].reshape(k * npad, -1)
        ys = Yp[order].reshape(k * npad, -1)
        W, T = scan_prefix_madd(rg, xs, ys, B)
        T = _unflat(T, k)
        rows = torch.arange(k, device=dev).unsqueeze(1)
        hist = torch.bincount((digits + rows * nb).reshape(-1), minlength=k * nb)
        q = hist.reshape(k, nb).cumsum(1) - 1
        qc = q.clamp(min=0)
        e_wb = tuple(w[rows * npad + qc] for w in W)
        ident_q = rg.identity((k, nb))
        before = _boundary_before(rg, T, torch.div(qc, B, rounding_mode="floor") - 1, ident_q)
        E = point_select(cf, q >= 0, rg.add(before, e_wb), ident_q)
        e_last = tuple(e[:, nb - 1] for e in E)
        sum_e = _reduce_pts(rg, tuple(e[:, : nb - 1] for e in E))
        t = _scale_pow2_minus1(rg, e_last, c)
        return rg.add(t, rg.neg(sum_e))

    # ------------- fixed-base (setup path) -------------
    def fixed_base_table(self, base_affine):
        """Window table T[w, d] = d * 2^(cw) * base, affine-encoded, built on
        the host (`host_group.window_table`) and moved to the device."""
        rows = self.host_group.window_table(base_affine, self.c, self.nwindows)
        enc = self.encode_points([pt for row in rows for pt in row])
        return tuple(t.reshape(self.nwindows, self.nb, *t.shape[1:]) for t in enc)

    def fixed_base_msm(self, table, scalars, pad_output: bool = False):
        """[s_i * base] as affine-encoded points. Padding follows the
        reference's accelerator rule (`ops/msm.py:1002-1011`): G1 pads to a
        multiple of COL_ALIGN from COL_ALIGN up, G2 (and small G1) to a power
        of two; padding rows (zero scalars) are infinity.

        Each window accumulates with K6 (`rg.madd`) on the gathered table
        rows (X[w][d], Y[w][d], d == 0), as `_fixed_base_rcb` does through
        `_wide_madd` (`ops/msm.py:917-925, 953`): the d = 0 row is
        infinity and leaves the accumulator as it is. The reference selects
        rows with a one-hot int8 matmul (XLA work, not a kernel); the port
        gathers. The projective output is normalized once."""
        rg = self.rg
        n = scalars.shape[0]
        if self.group == "g1" and n >= COL_ALIGN:
            np2 = _cdiv(n, COL_ALIGN) * COL_ALIGN
        else:
            np2 = max(8, 1 << (n - 1).bit_length())
        sc = scalars.to(torch.int64)
        if np2 != n:
            sc = torch.cat([sc, sc.new_zeros((np2 - n, sc.shape[1]))])
        X, Y, _ = table
        acc = rg.identity((np2,))
        for w in range(self.nwindows):
            bitpos = w * self.c
            d = (sc[:, bitpos // BASE_BITS] >> (bitpos % BASE_BITS)) & (self.nb - 1)
            acc = rg.madd(acc, (X[w][d], Y[w][d], d == 0))
        out = self._normalize_proj(acc)
        return out if pad_output else tuple(c[:n] for c in out)

    def _normalize_proj(self, p):
        """Projective -> affine-encoded Jacobian (Z in {0, one}); the Z
        inverses are one batch inversion (0 maps to 0), as the reference's
        `_normalize_proj` (`ops/msm.py:957-967`)."""
        cf = self.cf
        X, Y, Z = p
        zinv = cf.batch_inv(Z)
        xy = cf.mul(torch.stack([X, Y]), zinv)
        inf = cf.is_zero(Z)
        z = point_select(cf, inf, (cf.zeros(inf.shape),), (cf.ones(inf.shape),))[0]
        return (xy[0], xy[1], z)


_GROUPS: dict = {}


def device_group(curve, group: str, device="cuda") -> DeviceCurveGroup:
    key = (curve.name, group, str(torch.device(device)))
    g = _GROUPS.get(key)
    if g is None:
        g = _GROUPS[key] = DeviceCurveGroup(curve, group, device)
    return g

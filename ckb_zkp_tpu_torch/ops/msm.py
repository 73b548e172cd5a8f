"""Pippenger multi-scalar multiplication and fixed-base MSM on torch.

Port of the reference's `ops/msm.py` `DeviceCurveGroup` for G1 (over Fq)
and G2 (over Fq2): point/scalar encoding (`:431-536`), `msm` (`:539-586`)
with the RCB Pippenger `_msm_rcb` (`:741-814`), and the setup's
`fixed_base_msm` (`:982-1045`; the reference's K6 per window,
`_fixed_base_rcb` `:901-955`, is one K6 fixed-base launch here) with its
host-built window table (`:1047`).

Per window the MSM sorts the points by digit, runs K2 over the packed
affine leaves in that order (every within-block prefix W and block totals
T; K2 reads the leaves through the order, no sorted copy is made),
forms the bucket-boundary prefixes E_b = prefix(T, g_b - 1) + W[q_b]
(K3 levels, a Hillis-Steele top and K5), and telescopes the bucket
weighting to (2^c - 1) E_last - sum_{b < nb-1} E_b (K4 levels and a B = n
tail). Unlike the reference, which runs windows one at a time under
lax.scan, the port runs a batch of windows in every launch: the scans then
cover batch * N / 32 columns, which widens the small per-window grid of
the scan kernel, and the launch count per MSM drops by the batch size.
Batches are capped at 2^21 points to bound memory.

The Jacobian engine is the reference's other branch of `DeviceCurveGroup`
(`_use_rcb` False, `ops/msm.py:363`): `_msm_impl` (`:830-848`) runs the
windows one at a time through `_window_sum` (`:594-636`), whose bucket
boundaries come from `_prefix_boundary_leaf` and `_prefix_boundary_jac`
(`:670-733`) over sorted affine leaves (here read through the sort
order, never copied in it): K9b block totals, a K9c level,
a Hillis-Steele top and K8 combines, and the window folds (the Horner
sum over the window sums, `_window_sum`'s (2^c - 1) E_last) are one K8
chain launch each; the fixed-base MSM (`_fixed_base_impl`, `:883-899`,
which runs K9a once a window) is one K9a fixed-base launch here. For
the Weierstrass groups the port always takes the reference's accelerator
branch of that engine (affine leaves, block totals, the K9a fixed-base).
Both engines give the same affine points; every pairing curve of the
repo has a = 0, so the RCB engine is the default and the Jacobian one
runs where a caller sets `_use_rcb = False`.

A group that brings its own point operations (`p_add`, `p_double`,
`p_neg`, `p_identity`; the Ristretto group of `ristretto_device.py`)
clears `_affine_leaves` and runs the reference's generic branch of
`_window_sum` (`:594-636`, its `else` at `:623-625`): the points gathered
in digit order, their prefixes at the bucket ends by `prefix_at_indices`,
the sum of the E_b, c doublings of E_last, then the fold of `_msm_impl`
(`:840-848`). As in the Jacobian branch, the windows run in batches, and
the sum of the E_b is a halving tree (the same point as the reference's
Hillis-Steele scan, with fewer adds). `msm_many` runs the MSMs of such a
group that share one point list as one batch of window rows and one fold.

`msm_over_fixed_base` (`:1104-1144`) is the MSM over a prefix of a
generator list, whose device encoding is cached per list: the Pedersen
commitments of the discrete-log schemes.
"""

from __future__ import annotations

import torch

from ..host.curves import AffinePoint
from .cuda_ec import (block_totals_add, block_totals_madd, ec_add_chain, ec_fixed_base,
                      ec_madd)
from .cuda_rcb import (pack_limbs_flag, rcb_fixed_base, scan_prefix_add,
                       scan_prefix_madd, scan_prefix_madd_unpacked, scan_total_add)
from .ec import (DeviceFq2, ec_add, ec_double, ec_neg, point_infinity, point_select,
                 to_affine)
from .field import device_field
from .limbs import BASE_BITS, ints_to_limbs, limbs_to_ints
from .rcb import RcbGroup
from .scan_utils import hs_scan, prefix_at_indices, within_block_prefix
from .sparse import COL_ALIGN

_RCB_B = 32  # scan block: elements per sequential accumulation
_SMALL_SCAN_MAX = 32  # _reduce_pts finishes with one B = n launch below this
_TOP_MAX = 128  # _boundary_before finishes with a Hillis-Steele scan below this
_WINDOW_BATCH_POINTS = 1 << 21
_FIXED_BASE_BITS = 8  # fixed-base windows (the reference's device_group default)

# Jacobian engine sizing: the reference's TPU tiling rules, kept as module
# constants that tests patch small to reach every level at few points
_SCAN_B = 32  # K9b/K9c block (reference `_SCAN_B`)
_LEAF_GROUPS = 8 * 128  # K9b runs when n % (_SCAN_B * _LEAF_GROUPS) == 0 (SCAN_SUBS * 128)
_JAC_TOP = 2 * 32 * 128  # _prefix_boundary_jac scans Hillis-Steele at n <= this
_NORMALIZE_CHUNK = 1 << 18  # points a slice of the Jacobian fixed-base normalization


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


def _scan_prefix_madd(rg, leaves, B: int):
    """Sorted affine leaves (X, Y, inf) -> (w_get(q): the inclusive prefixes
    at positions q, T (G,) block totals), through K2a over the leaves
    padded with flagged ones to a multiple of B. Reference
    `_scan_prefix_madd` (`ops/msm.py:113-143`), whose kernel branch is K2a.
    As there, the prover does not call it (`_msm_rcb` scans packed leaves
    with K2); the window probe does."""
    X, Y, inf = leaves
    n = inf.shape[0]
    extra = _cdiv(n, B) * B - n
    if extra:
        X = torch.cat([X, X.new_zeros((extra, *X.shape[1:]))])
        Y = torch.cat([Y, Y.new_zeros((extra, *Y.shape[1:]))])
        inf = torch.cat([inf, inf.new_ones((extra,))])
    W, T = scan_prefix_madd_unpacked(rg, X, Y, inf, B)
    return (lambda q: tuple(w[q] for w in W)), T


def _bucket_ends(digits, nb: int):
    """q (k, nb): for each row of digits, the last position of bucket b in
    the row sorted by digit (that of the bucket before where b is empty, -1
    before the first non-empty bucket)."""
    k = digits.shape[0]
    rows = torch.arange(k, device=digits.device).unsqueeze(1)
    hist = torch.bincount((digits + rows * nb).reshape(-1), minlength=k * nb)
    return hist.reshape(k, nb).cumsum(1) - 1


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

    # the Jacobian engine's affine leaves and formulas; a subclass with its
    # own point operations (extended Edwards) clears it for the generic branch
    _affine_leaves = True

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
        # RCB projective engine: a = 0 short-Weierstrass groups (reference
        # `ops/msm.py:363`); else, or where a caller clears it, Jacobian
        self._use_rcb = self.host_group.a in (0, (0, 0))

    def _check_jacobian(self):
        """The Jacobian formulas are a = 0 formulas; the reference sends an
        a != 0 group to them and doubles it wrongly (no a Z^4 term,
        `ops/ec.py:100-117`). The port refuses such a group. A group with
        its own point operations (`_affine_leaves` False) does not use them."""
        if self._affine_leaves and self.host_group.a not in (0, (0, 0)):
            raise ValueError(
                f"{self.curve.name} {self.group}: the Jacobian engine's "
                f"formulas need a = 0, the group has a = {self.host_group.a}")

    # ------------- point ops of the Jacobian engine -------------
    def p_add(self, a, b):
        return ec_add(self.cf, a, b)

    def p_double(self, a):
        return ec_double(self.cf, a)

    def p_neg(self, a):
        return ec_neg(self.cf, a)

    def p_identity(self, batch_shape=()):
        return point_infinity(self.cf, batch_shape)

    def _normalize(self, P):
        """Jacobian -> affine-encoded Jacobian (Z in {0, one}), one batch
        inversion (reference `ops/msm.py:396-409`)."""
        x, y, inf = to_affine(self.cf, P)
        z = point_select(self.cf, inf, (self.cf.zeros(inf.shape),),
                         (self.cf.ones(inf.shape),))[0]
        return (x, y, z)

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

    def decode_points(self, P) -> list:
        """Jacobian (X, Y, Z) arrays -> host affine points, the affine
        coordinates formed on the device by one batch inversion (the
        reference's device branch of `decode_points`, `ops/msm.py:449-470`;
        for a key's queries, where `decode_points_host` pays one Python-int
        inversion a point)."""
        if P[0].shape[0] == 0:
            return []
        x, y, inf = to_affine(self.cf, P)
        host = self.host_group
        return [host.infinity if i else AffinePoint(a, b)
                for a, b, i in zip(self._coords_host(x), self._coords_host(y), inf.tolist())]

    # ------------- variable-base Pippenger -------------
    def msm(self, P, scalars):
        """Jacobian point sum_i s_i P_i. P affine-encoded (Z in {0, one});
        scalars (N, L) canonical. Points padded wider than the scalars (the
        reference's pow2-padded G2 query arrays) get zero-extended scalars."""
        if not self._affine_leaves:
            return self._msm_many_generic([(P, scalars)])[0]
        P, scalars = self._msm_operands(P, scalars)
        if self._use_rcb:
            return tuple(c[0] for c in self._msm_rcb([(P, scalars)]))
        self._check_jacobian()
        # the Jacobian engine pads to a power of two, at least 8, with
        # identity points and zero scalars (reference `ops/msm.py:576-586`)
        n_pts = P[0].shape[0]
        np2 = max(8, 1 << (n_pts - 1).bit_length())
        if np2 != n_pts:
            P = tuple(torch.cat([c, i]) for c, i in zip(P, self.p_identity((np2 - n_pts,))))
            scalars = torch.cat([scalars, scalars.new_zeros((np2 - n_pts, scalars.shape[1]))])
        return self._msm_impl(P, scalars)

    def msm_many(self, jobs) -> list:
        """[msm(P, scalars) for (P, scalars) in jobs], the same points. On
        the RCB engine, MSMs of one window width whose padded lengths are
        within a factor of two run as one batch: their windows share the
        K2-K5 launches (each padded to the batch's longest with flagged
        leaves and zero scalars), and one window fold of 272-288 K5
        launches serves them all, where each MSM alone pays its own. The
        Jacobian engine runs them one by one. A group with its own point
        operations runs the MSMs over one point list (the same tensors)
        as one `_msm_generic`: one batch of window rows, one fold."""
        if not self._use_rcb:
            if self._affine_leaves:
                return [self.msm(P, s) for P, s in jobs]
            return self._msm_many_generic(jobs)
        jobs = [self._msm_operands(P, s) for P, s in jobs]
        groups: list = []  # (window bits, shortest length, job indices)
        for i in sorted(range(len(jobs)), key=lambda i: jobs[i][1].shape[0]):
            n = jobs[i][1].shape[0]
            c = self._msm_window_bits(n)
            if groups and groups[-1][0] == c and n <= 2 * groups[-1][1]:
                groups[-1][2].append(i)
            else:
                groups.append((c, max(n, _RCB_B), [i]))
        out: list = [None] * len(jobs)
        for _, _, idx in groups:
            S = self._msm_rcb([jobs[j] for j in idx])
            for r, j in enumerate(idx):
                out[j] = tuple(c[r] for c in S)
        return out

    @staticmethod
    def _msm_operands(P, scalars):
        n_pts = P[0].shape[0]
        n = scalars.shape[0]
        if n_pts > n:
            scalars = torch.cat([scalars, scalars.new_zeros((n_pts - n, scalars.shape[1]))])
        elif n_pts < n:
            raise ValueError(f"msm: {n_pts} points for {n} scalars")
        return P, scalars

    @staticmethod
    def _msm_window_bits(n: int) -> int:
        """16-bit windows (digit == one scalar limb) once the 2^16-bucket
        machinery amortizes, 8-bit below (reference `ops/msm.py:736-739`)."""
        return 16 if n >= (1 << 18) else 8

    def _msm_rcb(self, jobs):
        """(m,) Jacobian points, one an MSM of `jobs` [(P, scalars)], all
        of the window width of the first. Every MSM is padded to the
        longest's npad (a multiple of _RCB_B) and its packed leaves laid
        out after the previous one's; row w of MSM j reads its leaves
        through its sort order shifted by j * npad. The window sums of
        all MSMs are folded together, one batch of m points a K5 launch."""
        rg, cf = self.rg, self.cf
        m = len(jobs)
        c = self._msm_window_bits(jobs[0][1].shape[0])
        nwin = self.fr.L * BASE_BITS // c
        npad = max(_cdiv(s.shape[0], _RCB_B) * _RCB_B for _, s in jobs)
        Xs, Ys, infs, digits = [], [], [], []
        bitpos = torch.arange(nwin, device=jobs[0][1].device) * c
        for (X, Y, Z), scalars in jobs:
            inf = cf.is_zero(Z)
            extra = npad - scalars.shape[0]
            if extra:
                X = torch.cat([X, X.new_zeros((extra, *X.shape[1:]))])
                Y = torch.cat([Y, Y.new_zeros((extra, *Y.shape[1:]))])
                inf = torch.cat([inf, inf.new_ones((extra,))])
                scalars = torch.cat([scalars, scalars.new_zeros((extra, scalars.shape[1]))])
            Xs.append(X)
            Ys.append(Y)
            infs.append(inf)
            limbs = scalars.to(torch.int64)[:, bitpos // BASE_BITS]
            digits.append(((limbs >> (bitpos % BASE_BITS)) & ((1 << c) - 1)).T)
        cat = (lambda t: t[0]) if m == 1 else torch.cat
        Xp, Yp = pack_limbs_flag(rg, cat(Xs), cat(Ys), cat(infs))
        digits = cat(digits).contiguous()  # (m * nwin, npad)
        offsets = (torch.arange(m * nwin, device=digits.device) // nwin * npad
                   if m > 1 else None)
        batch = max(1, min(m * nwin, _WINDOW_BATCH_POINTS // npad))
        parts = [
            self._windows(Xp, Yp, digits[w0 : w0 + batch], c,
                          None if offsets is None else offsets[w0 : w0 + batch])
            for w0 in range(0, m * nwin, batch)
        ]
        S = tuple(torch.cat(cs, dim=0).reshape(m, nwin, *cs[0].shape[1:])
                  for cs in zip(*parts))
        acc = rg.identity((m,))
        for i in range(nwin):
            for _ in range(c):
                acc = rg.add(acc, acc)
            acc = rg.add(acc, tuple(s[:, nwin - 1 - i] for s in S))
        return rg.to_jacobian(acc)

    def _windows(self, Xp, Yp, digits, c: int, offsets=None):
        """Window sums sum_b b * B_b for a (k, npad) batch of digit rows. K2
        reads each row's leaves through its sort order (leaf j of row w is
        Xp[order[w, j]], shifted by offsets[w] where rows of several MSMs
        share the leaves), so no sorted copy of the leaves is written."""
        order = torch.sort(digits, dim=1).indices
        if offsets is not None:
            order = order + offsets.unsqueeze(1)
        W, T = scan_prefix_madd(self.rg, Xp, Yp, _RCB_B, order=order.reshape(-1))
        return self._weigh_buckets(self._bucket_prefixes(W, T, digits, c), c)

    def _bucket_prefixes(self, W, T, digits, c: int):
        """E (k, nb): each row's inclusive prefix of its sorted leaves at
        the end of each bucket, E_b = prefix(T, g_b - 1) + W[q_b] (the
        identity before the first non-empty bucket), from a scan's W
        (k * npad,) and block totals T (k * npad / B,)."""
        rg = self.rg
        k, npad = digits.shape
        nb = 1 << c
        q = _bucket_ends(digits, nb)
        qc = q.clamp(min=0)
        rows = torch.arange(k, device=digits.device).unsqueeze(1)
        e_wb = tuple(w[rows * npad + qc] for w in W)
        ident_q = rg.identity((k, nb))
        before = _boundary_before(rg, _unflat(T, k),
                                  torch.div(qc, _RCB_B, rounding_mode="floor") - 1, ident_q)
        return point_select(self.cf, q >= 0, rg.add(before, e_wb), ident_q)

    def _weigh_buckets(self, E, c: int):
        """sum_b b * B_b per row from the bucket-end prefixes E (k, nb): it
        telescopes to (2^c - 1) E_last - sum_{b < nb-1} E_b."""
        rg = self.rg
        nb = 1 << c
        e_last = tuple(e[:, nb - 1] for e in E)
        sum_e = _reduce_pts(rg, tuple(e[:, : nb - 1] for e in E))
        t = _scale_pow2_minus1(rg, e_last, c)
        return rg.add(t, rg.neg(sum_e))

    # ------------- Jacobian Pippenger -------------
    def _digits(self, scalars, w: int):
        """c-bit digit w of (N, L) canonical 16-bit scalar limbs."""
        bitpos = w * self.c
        limb = scalars[:, bitpos // BASE_BITS].to(torch.int64)
        return (limb >> (bitpos % BASE_BITS)) & (self.nb - 1)

    def _msm_impl(self, P, scalars):
        """Jacobian sum_i s_i P_i over c-bit windows (reference
        `ops/msm.py:830-848`), then the fold sum_w 2^(cw) S_w by doublings.
        P affine-encoded: its leaves are (X, Y, Z == 0). The reference runs
        the windows one at a time; the port runs them in batches of up to
        _WINDOW_BATCH_POINTS leaves, as `_msm_rcb` does, so each K9b, K9c
        and K8 launch covers a batch of windows. The fold is one K8 chain
        launch: W rounds of c doublings t + t and an add, from infinity (the
        loop of W (c + 1) K8 launches it replaces, the same bits)."""
        X, Y, Z = P
        leaves = (X, Y, self.cf.is_zero(Z))
        n, W = X.shape[0], self.nwindows
        digits = torch.stack([self._digits(scalars, w) for w in range(W)])
        batch = max(1, min(W, _WINDOW_BATCH_POINTS // n))
        parts = [self._window_sums(leaves, digits[w0 : w0 + batch])
                 for w0 in range(0, W, batch)]
        S = tuple(torch.cat(cs) for cs in zip(*parts))  # (W,)
        addends = tuple(s.flip(0).unsqueeze(1) for s in S)  # (W, 1), the top window first
        acc = ec_add_chain(self.cf, self.p_identity((1,)), addends, [self.c] * W)
        return tuple(a[0] for a in acc)

    def _window_sums(self, leaves, digits):
        """sum_b b * B_b for each row of (k, n) digits (reference
        `_window_sum`, `ops/msm.py:594-636`): sort the leaves by digit, take
        the inclusive prefixes E_b at the bucket boundaries, and telescope
        (nb - 1) E_last - sum_{b < nb-1} E_b. The leaves are read through
        the sort order, not copied in it: K9b and the within-block rows
        take row order[j, i] of the n leaves where the reference gathers
        the sorted leaves of each window. The reference sums the E_b as
        the last element of a Hillis-Steele scan; the port adds them in a
        halving tree, the same point with nb - 2 adds. The reference doubles
        with `ec_double` (`p_double`); here and in the fold the port doubles
        with K8's t + t, whose doubling branch is `ec_double`'s formula
        (infinity stays infinity, in another representative), where the
        torch composition is some 200 launches of tiny ops (with it, a
        2^20-point G1 MSM made 97511 launches and took 1.29 s on an H100).
        The c doublings of E_last and the two closing adds are one K8 chain
        launch (the c + 2 K8 launches of the loop, the same bits)."""
        nb = self.nb
        order = torch.sort(digits, dim=1).indices
        ar = torch.arange(nb, device=digits.device).expand(digits.shape[0], nb)
        cnt = torch.searchsorted(torch.gather(digits, 1, order), ar.contiguous(), right=True)
        E = self._prefix_boundary_leaf(leaves, order, cnt - 1)
        e_last = tuple(e[:, nb - 1] for e in E)
        sum_e = self._sum_dim1(tuple(e[:, : nb - 1] for e in E))
        addends = tuple(torch.stack(ab) for ab in zip(self.p_neg(e_last), self.p_neg(sum_e)))
        return ec_add_chain(self.cf, e_last, addends, [self.c, 0])

    def _sum_dim1(self, pts):
        """(k, n) points -> (k,) sums, by a halving tree of K8 adds."""
        while pts[0].shape[1] > 1:
            if pts[0].shape[1] % 2:
                pad = self.p_identity((pts[0].shape[0], 1))
                pts = tuple(torch.cat([c, i], dim=1) for c, i in zip(pts, pad))
            pts = self.p_add(tuple(c[:, 0::2] for c in pts), tuple(c[:, 1::2] for c in pts))
        return tuple(c[:, 0] for c in pts)

    def _promote_leaves(self, lv):
        """Affine leaves (x, y, inf) -> Jacobian (x, y, 0 or one)."""
        x, y, m = lv
        z = point_select(self.cf, m, (self.cf.zeros(m.shape),), (self.cf.ones(m.shape),))[0]
        return (x, y, z)

    def _prefix_boundary_leaf(self, leaves, order, q):
        """Inclusive prefix at each q (q = -1: infinity) over k rows of
        sorted affine leaves, row j's leaf i being leaves[order[j, i]]
        (leaves (n,), order (k, n) int64), q (k, Q) (reference
        `ops/msm.py:670-704`): K9b block totals read through the order,
        their prefix before each query's block, and the query's
        within-block rows read through it too. n must be a multiple of
        _SCAN_B * _LEAF_GROUPS (2^15 leaves); else `prefix_at_indices`
        with K9a leaf combines over a sorted copy of the leaves (below 2^15
        points, off the 2^20 path; the copy is at most 2^15 rows a
        window)."""
        k, n = order.shape
        B = _SCAN_B
        if n % (B * _LEAF_GROUPS):
            lid = (self.cf.zeros(), self.cf.zeros(),
                   torch.ones((), dtype=torch.bool, device=order.device))
            return prefix_at_indices(
                self.p_add, tuple(c[order] for c in leaves), self.p_identity(), q,
                leaf_combine=lambda acc, lv: ec_madd(self.cf, acc, lv),
                leaf_identity=lid, promote=self._promote_leaves)
        totals = block_totals_madd(self.cf, leaves, B, order=order.reshape(-1))
        return self._combine_blocks(_unflat(totals, k), leaves, q, self._promote_leaves,
                                    order)

    def _prefix_boundary_jac(self, pts, q):
        """The Jacobian-level recursion over (k, n) points (reference
        `ops/msm.py:706-733`): a Hillis-Steele scan at n <= _JAC_TOP, else
        K9c block totals over rows padded with infinity to a
        _SCAN_B * _LEAF_GROUPS multiple."""
        k, n = pts[0].shape[:2]
        if n <= _JAC_TOP:
            return prefix_at_indices(self.p_add, pts, self.p_identity(), q, hs_base=n)
        blk = _SCAN_B * _LEAF_GROUPS
        pts = _pad_dim1(pts, _cdiv(n, blk) * blk, self.p_identity())
        totals = block_totals_add(self.cf, _flat(pts), _SCAN_B)
        return self._combine_blocks(_unflat(totals, k), pts, q)

    def _combine_blocks(self, totals, elems, q, promote=None, order=None):
        """prefix(totals, q // B - 1) + elems' within-block prefix up to q,
        infinity where q < 0: the common tail of both boundary levels
        (`order`: elems are rows read through it, as in
        `within_block_prefix`)."""
        B = _SCAN_B
        qc = q.clamp(min=0)
        gq = torch.div(qc, B, rounding_mode="floor")
        before = self._prefix_boundary_jac(totals, gq - 1)
        part2 = within_block_prefix(self.p_add, elems, self.p_identity(), gq,
                                    qc - gq * B, B, promote, order)
        out = self.p_add(before, part2)
        return point_select(self.cf, q >= 0, out, self.p_identity(q.shape))

    # ------------- the generic branch (a group's own point operations) -------------
    def _msm_many_generic(self, jobs) -> list:
        """`msm_many` for a group with its own point operations: the jobs
        over one point list (the same tensors, the same length) share one
        `_msm_generic` call."""
        out: list = [None] * len(jobs)
        groups: dict = {}
        for i, (P, s) in enumerate(jobs):
            P, s = self._msm_operands(P, s)
            group = groups.setdefault((id(P[0]), P[0].shape[0]), (P, [], []))
            group[1].append(i)
            group[2].append(s)
        for P, idx, rows in groups.values():
            n_pts = P[0].shape[0]
            np2 = max(8, 1 << (n_pts - 1).bit_length())
            sc = torch.stack(rows)
            if np2 != n_pts:
                P = tuple(torch.cat([c, i]) for c, i in zip(P, self.p_identity((np2 - n_pts,))))
                sc = torch.cat([sc, sc.new_zeros((sc.shape[0], np2 - n_pts, sc.shape[2]))], 1)
            S = self._msm_generic(P, sc)
            for r, j in enumerate(idx):
                out[j] = tuple(c[r] for c in S)
        return out

    def _msm_generic(self, P, scalars):
        """(m,) points sum_i s_ji P_i for m scalar rows (m, n, L) over one
        list of n points (reference `_msm_impl`, `ops/msm.py:830-848`, with
        `_affine_leaves` False): the c-bit windows of every row, in batches
        of up to _WINDOW_BATCH_POINTS gathered points, then the fold
        sum_w 2^(cw) S_w by c doublings and an add a window."""
        m, n = scalars.shape[:2]
        W = self.nwindows
        bitpos = torch.arange(W, device=scalars.device) * self.c
        limbs = scalars.to(torch.int64)[:, :, bitpos // BASE_BITS]  # (m, n, W)
        digits = ((limbs >> (bitpos % BASE_BITS)) & (self.nb - 1)).transpose(1, 2)
        digits = digits.reshape(m * W, n)
        batch = max(1, min(m * W, _WINDOW_BATCH_POINTS // n))
        parts = [self._window_sums_generic(P, digits[r0 : r0 + batch])
                 for r0 in range(0, m * W, batch)]
        S = tuple(torch.cat(cs).reshape(m, W, *cs[0].shape[1:]) for cs in zip(*parts))
        acc = self.p_identity((m,))
        for i in range(W):
            for _ in range(self.c):
                acc = self.p_double(acc)
            acc = self.p_add(acc, tuple(s[:, W - 1 - i] for s in S))
        return acc

    def _window_sums_generic(self, P, digits):
        """sum_b b * B_b for each row of (k, n) digits over the points P
        (reference `_window_sum`'s generic branch, `ops/msm.py:617-636`):
        the points in digit order, the inclusive prefixes E_b at the
        bucket ends, and (nb - 1) E_last - sum_{b < nb-1} E_b, where
        (nb - 1) E_last = 2^c E_last - E_last."""
        nb = self.nb
        order = torch.sort(digits, dim=1).indices
        ar = torch.arange(nb, device=digits.device).expand(digits.shape[0], nb)
        cnt = torch.searchsorted(torch.gather(digits, 1, order), ar.contiguous(), right=True)
        E = prefix_at_indices(self.p_add, tuple(c[order] for c in P), self.p_identity(),
                              cnt - 1)
        e_last = tuple(e[:, nb - 1] for e in E)
        sum_e = self._sum_dim1(tuple(e[:, : nb - 1] for e in E))
        t = e_last
        for _ in range(self.c):
            t = self.p_double(t)
        acc = self.p_add(t, self.p_neg(e_last))
        return self.p_add(acc, self.p_neg(sum_e))

    # ------------- fixed-base (setup path) -------------
    def fixed_base_table(self, base_affine):
        """Window table T[w, d] = d * 2^(cw) * base, affine-encoded, built on
        the host (`host_group.window_table`) and moved to the device."""
        rows = self.host_group.window_table(base_affine, self.c, self.nwindows)
        enc = self.encode_points([pt for row in rows for pt in row])
        return tuple(t.reshape(self.nwindows, self.nb, *t.shape[1:]) for t in enc)

    def fixed_base(self, base_affine) -> "FixedBase":
        """Lazy fixed-base context (reference `ops/msm.py:1068`): the window
        table is built on its first use."""
        return FixedBase(self, base_affine)

    def fixed_base_msm(self, table, scalars, pad_output: bool = False):
        """[s_i * base] as affine-encoded points; `table` is a window table
        or a `FixedBase`. Padding follows the
        reference's accelerator rules (`ops/msm.py:1002-1011`): the RCB
        engine pads G1 to a multiple of COL_ALIGN from COL_ALIGN up, G2
        (and small G1) to a power of two; the Jacobian engine pads every
        query to a power of two, at least 8. Padding rows (zero scalars)
        are infinity.

        RCB: one K6 fixed-base launch (`cuda_rcb.rcb_fixed_base`) runs
        each point's windows as a chain of mixed adds from the identity over
        the table rows (X[w][d], Y[w][d]) its digits pick, skipping d = 0
        (row 0 is infinity), as `_fixed_base_rcb` does window by window
        through `_wide_madd` (`ops/msm.py:917-925, 953`); the reference
        selects the rows with a one-hot int8 matmul (XLA work, not a
        kernel), the kernel reads them through the digits. The projective
        output is normalized once. Jacobian: one K9a fixed-base launch
        (`cuda_ec.ec_fixed_base`), the same chain of Jacobian mixed adds
        from infinity, where the reference runs K9a once a window on
        gathered rows in chunks of scalars (`_fixed_base_impl` `:883-899`,
        `_fixed_base_chunked` `:969-980`); `_normalize` runs after it over
        slices of _NORMALIZE_CHUNK points, in place, which bounds its batch
        inversion's temporaries as the reference's chunks do (an all-zero
        scalar's infinity, in another representative than the window
        loop's, normalizes to the same (0, 0, 0))."""
        if isinstance(table, FixedBase):
            table = table.table
        n = scalars.shape[0]
        if not self._use_rcb:
            self._check_jacobian()
        if self._use_rcb and self.group == "g1" and n >= COL_ALIGN:
            np2 = _cdiv(n, COL_ALIGN) * COL_ALIGN
        else:
            np2 = max(8, 1 << (n - 1).bit_length())
        sc = scalars
        if np2 != n:
            sc = torch.cat([sc, sc.new_zeros((np2 - n, sc.shape[1]))])
        X, Y, _ = table
        if self._use_rcb:
            out = self._normalize_proj(rcb_fixed_base(self.rg, X, Y, sc))
        else:
            out = ec_fixed_base(self.cf, X, Y, sc)
            for i in range(0, np2, _NORMALIZE_CHUNK):
                part = self._normalize(tuple(c[i : i + _NORMALIZE_CHUNK] for c in out))
                for c, q in zip(out, part):
                    c[i : i + _NORMALIZE_CHUNK] = q
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


class FixedBase:
    """A base point and its window table, built at the first use (reference
    `ops/msm.py:1074-1083`)."""

    def __init__(self, dg: DeviceCurveGroup, base_affine):
        self.dg = dg
        self.base_affine = base_affine
        self._table = None

    @property
    def table(self):
        if self._table is None:
            self._table = self.dg.fixed_base_table(self.base_affine)
        return self._table


_GROUPS: dict = {}


def device_group(curve, group: str, device="cuda") -> DeviceCurveGroup:
    """The cached group of (curve, group, device). "cuda" and the current
    card's "cuda:N" name one group, so the setup (given "cuda") and the
    prover (given its keys' device) share it and its `_use_rcb`."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (curve.name, group, str(dev))
    g = _GROUPS.get(key)
    if g is None:
        g = _GROUPS[key] = DeviceCurveGroup(curve, group, dev)
    return g


# ---- the MSM over a fixed generator list, its device encoding cached ----
# Pedersen commitments MSM over the same generator list again and again
# (Spartan's packing commitments; Hyrax's, Libra's and Bulletproofs' when
# their slices come). Reference `ops/msm.py:1097-1144`.
FIXED_BASE_MSM_MIN = 1 << 10
_fixed_base_cache: dict = {}


def _fixed_base_group(curve, device):
    if getattr(curve, "name", "") == "curve25519":
        from .ristretto_device import device_ristretto_group

        return device_ristretto_group(device=device)
    return device_group(curve, "g1", device)


def _encoded_list(dg, base_points, cache: bool):
    """The device encoding of `base_points`, memoized per list and device
    with `cache` (the reference's guard `ent[0] is base_points`: a freed
    list's id can come back)."""
    if not cache:
        return dg.encode_points(base_points)
    key = (id(base_points), str(dg.device))
    ent = _fixed_base_cache.get(key)
    if ent is None or ent[0] is not base_points:
        ent = _fixed_base_cache[key] = (base_points, dg.encode_points(base_points))
    return ent[1]


def msm_over_fixed_base(curve, base_points: list, scalars: list, cache: bool = True,
                        device="cuda"):
    """sum_i scalars[i] * base_points[i] over a prefix of a generator list
    (reference `ops/msm.py:1104-1144`): `msm_over_fixed_base_many` of one
    row."""
    return msm_over_fixed_base_many(curve, base_points, [scalars], cache, device)[0]


def msm_over_fixed_base_many(curve, base_points: list, rows: list, cache: bool = True,
                             device="cuda") -> list:
    """[sum_i s[i] * base_points[i] for s in rows] over prefixes of one
    generator list. A row below FIXED_BASE_MSM_MIN scalars, every row on an
    Edwards curve, and every row where the rows differ in length, runs the
    host Pippenger (the reference's gate, `ops/msm.py:1104-1144`); else the
    rows run as one `msm_many` over the list's cached encoding on `device`
    (one batch of window rows and one fold, where each MSM alone pays its
    own): the Ristretto group for curve25519, G1 (`device_group`) for
    every other curve. cache=False for one-shot lists, whose encodings are
    not kept."""
    if not rows or len(rows[0]) < FIXED_BASE_MSM_MIN or getattr(curve, "is_edwards", False) \
            or any(len(s) != len(rows[0]) for s in rows):
        return [curve.g1.msm(base_points[: len(s)], s) for s in rows]
    dg = _fixed_base_group(curve, device)
    P = tuple(c[: len(rows[0])] for c in _encoded_list(dg, base_points, cache))
    return [dg.decode_point(S) for S in dg.msm_many([(P, dg.encode_scalars(s)) for s in rows])]


_GENERATOR_CHUNK = 1 << 18  # scalars a fixed-base launch takes in `generator_multiples`


def generator_multiples(curve, scalars: list, device="cuda") -> list:
    """[s * curve.g1_gen for s in scalars] as host points (Spartan's random
    generators). From FIXED_BASE_MSM_MIN scalars up on a short-Weierstrass
    curve, the fixed-base MSM of G1 on `device` (`fixed_base_msm`: K6 on
    the RCB engine) in chunks of _GENERATOR_CHUNK, each normalized by one
    batch inversion on the device; below, and for curve25519 and Edwards
    curves, the host's `mul` a scalar, as the reference draws them."""
    if len(scalars) < FIXED_BASE_MSM_MIN or getattr(curve, "is_edwards", False) \
            or getattr(curve, "name", "") == "curve25519":
        return [curve.g1.mul(curve.g1_gen, s) for s in scalars]
    dg = device_group(curve, "g1", device)
    fb = dg.fixed_base(curve.g1_gen)
    out: list = []
    for i in range(0, len(scalars), _GENERATOR_CHUNK):
        part = scalars[i : i + _GENERATOR_CHUNK]
        out += dg.decode_points(dg.fixed_base_msm(fb, dg.encode_scalars(part)))
    return out

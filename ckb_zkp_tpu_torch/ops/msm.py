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
which runs K9a once a window) is one K9a fixed-base launch here. The port
always takes the reference's accelerator branch of that engine (affine
leaves, block totals, the K9a fixed-base), so it keeps no
`_affine_leaves` flag. Both
engines give the same affine points; every pairing curve of the repo has
a = 0, so the RCB engine is the default and the Jacobian one runs where a
caller sets `_use_rcb = False`.
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
        `ops/ec.py:100-117`). The port refuses such a group."""
        if self.host_group.a not in (0, (0, 0)):
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
        n_pts = P[0].shape[0]
        n = scalars.shape[0]
        if n_pts > n:
            scalars = torch.cat([scalars, scalars.new_zeros((n_pts - n, scalars.shape[1]))])
        elif n_pts < n:
            raise ValueError(f"msm: {n_pts} points for {n} scalars")
        if self._use_rcb:
            return self._msm_rcb(P, scalars)
        self._check_jacobian()
        # the Jacobian engine pads to a power of two, at least 8, with
        # identity points and zero scalars (reference `ops/msm.py:576-586`)
        np2 = max(8, 1 << (n_pts - 1).bit_length())
        if np2 != n_pts:
            P = tuple(torch.cat([c, i]) for c, i in zip(P, self.p_identity((np2 - n_pts,))))
            scalars = torch.cat([scalars, scalars.new_zeros((np2 - n_pts, scalars.shape[1]))])
        return self._msm_impl(P, scalars)

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
        """Window sums sum_b b * B_b for a (k, npad) batch of digit rows. K2
        reads each row's leaves through its sort order (leaf j of row w is
        Xp[order[w, j]]), so no sorted copy of the leaves is written."""
        order = torch.sort(digits, dim=1).indices
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

    # ------------- fixed-base (setup path) -------------
    def fixed_base_table(self, base_affine):
        """Window table T[w, d] = d * 2^(cw) * base, affine-encoded, built on
        the host (`host_group.window_table`) and moved to the device."""
        rows = self.host_group.window_table(base_affine, self.c, self.nwindows)
        enc = self.encode_points([pt for row in rows for pt in row])
        return tuple(t.reshape(self.nwindows, self.nb, *t.shape[1:]) for t in enc)

    def fixed_base_msm(self, table, scalars, pad_output: bool = False):
        """[s_i * base] as affine-encoded points. Padding follows the
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

"""Sumcheck eval tables on the device.

Port of the reference's `ops/sumcheck.py`. The sumcheck schemes (Spartan,
Libra, Hyrax) run O(log n) rounds, each a recurrence over halving eval
tables (`combine_with_r` / `bound_poly_var_bot`). Here the tables live on
`device` as (N, L) Montgomery limb tensors (`DeviceField`), and only the
2-3 round scalars cross to the host, where the sigma commitments and the
transcript run. Every product is K1 (`DeviceField.mul`); adds, subs and
the tree sums are plain torch, as elsewhere in the port.

`gkr_tables_phase_one`/`gkr_tables_phase_two` build Libra's and Hyrax's
bookkeeping tables with the port's segment sum (`scan_utils.segment_sum`,
which takes the place of the reference's `segment_sum_sorted`).
"""

from __future__ import annotations

import numpy as np
import torch

from .field import DeviceField, device_field
from .scan_utils import SegmentLayout, segment_sum


class DeviceSumcheck:
    """Batched table ops for one scalar field on `device`."""

    def __init__(self, spec, device="cuda"):
        self.spec = spec
        self.fr: DeviceField = device_field(spec, device)

    # ---- host <-> device ----
    def encode_table(self, values: list[int]) -> torch.Tensor:
        return self.fr.encode(values)

    def decode_scalar(self, v) -> int:
        return self.fr.decode(v.reshape(1, -1))[0]

    # ---- halving recurrences ----
    def bind(self, table: torch.Tensor, r: int) -> torch.Tensor:
        """combine_with_r: lo + r*(hi - lo), halving the leading axis."""
        fr = self.fr
        lo, hi = self._halves(table)
        return fr.add(lo, fr.mul(fr.encode([r]), fr.sub(hi, lo)))

    @staticmethod
    def _halves(table):
        half = table.shape[0] // 2
        return table[:half], table[half:]

    def _extend(self, lo, hi, k: int):
        """combine_with_n at integer point k: lo + k*(hi - lo), k in {2,3}."""
        fr = self.fr
        d = fr.sub(hi, lo)
        out = fr.add(lo, fr.add(d, d))
        if k == 3:
            out = fr.add(out, d)
        return out

    def _sum(self, v):
        """Tree-sum a (N, L) Montgomery column down to one element."""
        fr = self.fr
        while v.shape[0] > 1:
            half = v.shape[0] // 2
            v = fr.add(v[:half], v[half:])
        return v[0]

    # ---- round kernels ----
    def cubic_round(self, pa, pb, pc, peq) -> tuple[int, int, int]:
        """(eval_0, eval_2, eval_3) of sum_j peq*(pa*pb - pc) (phase one)."""
        fr = self.fr

        def g(a, b, c, e):
            return self._sum(fr.mul(e, fr.sub(fr.mul(a, b), c)))

        al, ah = self._halves(pa)
        bl, bh = self._halves(pb)
        cl, ch = self._halves(pc)
        el, eh = self._halves(peq)
        e0 = g(al, bl, cl, el)
        e2 = g(
            self._extend(al, ah, 2), self._extend(bl, bh, 2),
            self._extend(cl, ch, 2), self._extend(el, eh, 2),
        )
        e3 = g(
            self._extend(al, ah, 3), self._extend(bl, bh, 3),
            self._extend(cl, ch, 3), self._extend(el, eh, 3),
        )
        vals = fr.decode(torch.stack([e0, e2, e3]))
        return vals[0], vals[1], vals[2]

    def cubic3_round_many(self, triples) -> list[tuple[int, int, int]]:
        """(e0, e2, e3) of sum_j a*b*c for many (A, B, C) tables with one
        decode transfer (the SPARK batched cubic sumcheck round, ckb-zkp
        spartan/src/prover.rs:1442-1607: parallel left*right*eq triples
        and sequential row*col*val triples share one round)."""
        fr = self.fr
        outs = []
        for A, B, C in triples:
            al, ah = self._halves(A)
            bl, bh = self._halves(B)
            cl, ch = self._halves(C)
            outs.append(self._sum(fr.mul(fr.mul(al, bl), cl)))
            for k in (2, 3):
                outs.append(self._sum(fr.mul(
                    fr.mul(self._extend(al, ah, k), self._extend(bl, bh, k)),
                    self._extend(cl, ch, k))))
        vals = fr.decode(torch.stack(outs))
        return [tuple(vals[i : i + 3]) for i in range(0, len(vals), 3)]

    def quad_round(self, pabc, pz) -> tuple[int, int]:
        """(eval_0, eval_2) of sum_j pabc*pz (phase two)."""
        fr = self.fr
        al, ah = self._halves(pabc)
        zl, zh = self._halves(pz)
        e0 = self._sum(fr.mul(al, zl))
        e2 = self._sum(fr.mul(self._extend(al, ah, 2), self._extend(zl, zh, 2)))
        vals = fr.decode(torch.stack([e0, e2]))
        return vals[0], vals[1]

    def first(self, table) -> int:
        return self.decode_scalar(table[0])

    def firsts(self, *tables) -> list[int]:
        """Decode element 0 of several tables with one transfer."""
        return self.fr.decode(torch.stack([t[0] for t in tables]))

    # ---- libra/hyrax GKR round kernels (ckb-zkp libra/src/sumcheck.rs:21-176) ----
    def libra_p1_round(self, pf, pmul, pa1, pa2) -> tuple[int, int]:
        """(eval_0, eval_2) of sum_j f*mul + f*a1 + a2 (phase one)."""
        fr = self.fr

        def g(f, m, a1, a2):
            return self._sum(fr.add(fr.mul(f, fr.add(m, a1)), a2))

        fl, fh = self._halves(pf)
        ml, mh = self._halves(pmul)
        al, ah = self._halves(pa1)
        bl, bh = self._halves(pa2)
        e0 = g(fl, ml, al, bl)
        e2 = g(
            self._extend(fl, fh, 2), self._extend(ml, mh, 2),
            self._extend(al, ah, 2), self._extend(bl, bh, 2),
        )
        vals = fr.decode(torch.stack([e0, e2]))
        return vals[0], vals[1]

    def libra_p2_round(self, pf, pmul, padd, fu: int) -> tuple[int, int]:
        """(eval_0, eval_2) of sum_j mul*f*fu + add*fu + add*f (phase two)."""
        fr = self.fr
        fu_enc = fr.encode([fu])

        def g(f, m, a):
            return self._sum(fr.add(fr.mul(f, fr.add(fr.mul(m, fu_enc), a)),
                                    fr.mul(a, fu_enc)))

        fl, fh = self._halves(pf)
        ml, mh = self._halves(pmul)
        al, ah = self._halves(padd)
        e0 = g(fl, ml, al)
        e2 = g(self._extend(fl, fh, 2), self._extend(ml, mh, 2), self._extend(al, ah, 2))
        vals = fr.decode(torch.stack([e0, e2]))
        return vals[0], vals[1]

    # ---- hyrax data-parallel zk sumcheck rounds (ckb-zkp hyrax/src/
    # zk_sumcheck_proof.rs:493-620): tables carry a leading gate axis and
    # halve along the instance/node axis ----
    def bind_axis1(self, T: torch.Tensor, r: int) -> torch.Tensor:
        """combine_with_r along axis 1 of a (G, n, L) table."""
        fr = self.fr
        lo, hi = self._halves1(T)
        return fr.add(lo, fr.mul(fr.encode([r]), fr.sub(hi, lo)))

    @staticmethod
    def _halves1(T):
        half = T.shape[1] // 2
        return T[:, :half], T[:, half:]

    def _op_gate(self, mulmask, a, b):
        """Per-gate add/mul select: mulmask (G,) bool over (G, s, L)."""
        fr = self.fr
        m = torch.as_tensor(mulmask, device=a.device).reshape(-1, 1, 1)
        return torch.where(m, fr.mul(a, b), fr.add(a, b))

    def hyrax_p1_round(self, TP, CE, li, ri, mulmask):
        """(e0, e2, e3) of sum_{g,t} tp[g,t] * op_g(ce[l_g,t], ce[r_g,t])."""
        fr = self.fr

        def g(tp, ce):
            v = fr.mul(tp, self._op_gate(mulmask, ce[li], ce[ri]))
            return self._sum(v.reshape(-1, v.shape[-1]))

        tl, th = self._halves1(TP)
        cl, ch = self._halves1(CE)
        e0 = g(tl, cl)
        e2 = g(self._extend(tl, th, 2), self._extend(cl, ch, 2))
        e3 = g(self._extend(tl, th, 3), self._extend(cl, ch, 3))
        vals = fr.decode(torch.stack([e0, e2, e3]))
        return vals[0], vals[1], vals[2]

    def hyrax_p23_round(self, EQ, V, tpx, pergate, mulmask):
        """(e0, e2) of sum_{g,i} eq[g,i] * tpx[g] * op_g(v[i], pergate[g])."""
        fr = self.fr

        def g(eq, v):
            a, b = torch.broadcast_tensors(v[None], pergate[:, None])
            t = fr.mul(fr.mul(eq, tpx[:, None]), self._op_gate(mulmask, a, b))
            return self._sum(t.reshape(-1, t.shape[-1]))

        el, eh = self._halves1(EQ)
        vl, vh = self._halves(V)
        e0 = g(el, vl)
        e2 = g(self._extend(el, eh, 2), self._extend(vl, vh, 2))
        vals = fr.decode(torch.stack([e0, e2]))
        return vals[0], vals[1]

    def one_hot_rows(self, ids, n: int) -> torch.Tensor:
        """(G, n, L) Montgomery one-hot rows: row g is e_{ids[g]} (eval_eq
        of the bit decomposition of an integer point is an indicator)."""
        fr = self.fr
        idv = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=fr.device)
        mask = torch.arange(n, device=fr.device)[None, :] == idv[:, None]
        return torch.where(mask[..., None], fr.ones(()), fr.zeros(()))

    # ---- GKR bookkeeping tables on the device (ckb-zkp libra/src/
    # evaluate.rs:79-120, libra_linear_gkr.rs:201-244) ----
    def eval_eq(self, rs: list[int]) -> torch.Tensor:
        """eq(x, rs) over x in {0,1}^len as (2^len, L) Montgomery limbs
        (bit-reversed build order, as spartan.polynomial.eval_eq)."""
        fr = self.fr
        table = fr.ones((1,))
        for r in reversed(rs):
            hi = fr.mul(table, fr.encode([r]))
            table = torch.cat([fr.sub(table, hi), hi], dim=0)
        return table

    def eval_value(self, table: torch.Tensor, rs: list[int]) -> torch.Tensor:
        """<table, eq(rs)> as a (1, L) Montgomery element (stays on the device)."""
        fr = self.fr
        eq = self.eval_eq(rs)
        n = min(table.shape[0], eq.shape[0])
        return self._sum(fr.mul(table[:n], eq[:n]))[None]


def _seg_acc(fr, targets, vals, n: int):
    """out[t] = sum of vals[j] with targets[j] == t, (n, L): the reference's
    sorted-target scatter-add (`segment_sum_sorted`) as the port's segment
    sum; field addition is exact, so the order of the terms does not matter."""
    if len(targets) == 0:
        return fr.zeros((n,))
    layout = SegmentLayout(np.asarray(targets, dtype=np.int64), n, fr.device)
    order = torch.as_tensor(layout.order, device=fr.device)
    return segment_sum(fr, vals[order], layout)


def _idx(fr, xs):
    return torch.as_tensor(np.asarray(xs, dtype=np.int64).reshape(-1), device=fr.device)


def gkr_tables_phase_one(ds, eg, v_dev, gates, bit_size: int):
    """Device eval_hg: the gates' contributions scatter-added into the
    (2^bit_size,) mul/add tables (ckb-zkp libra/src/evaluate.rs:79-103).
    `eg` is the (ng,) eq-combination table, `v_dev` the (n,) value vector,
    `gates` the static gate list."""
    fr = ds.fr
    n = 1 << bit_size
    muls = [g for g in gates if g.op == 1]
    adds = [g for g in gates if g.op == 0]
    if muls:
        mg, my = _idx(fr, [g.g for g in muls]), _idx(fr, [g.right_node for g in muls])
        mul_hg = _seg_acc(fr, [g.left_node for g in muls], fr.mul(eg[mg], v_dev[my]), n)
    else:
        mul_hg = fr.zeros((n,))
    if adds:
        ag, ay = _idx(fr, [g.g for g in adds]), _idx(fr, [g.right_node for g in adds])
        add_x = [g.left_node for g in adds]
        add_hg1 = _seg_acc(fr, add_x, eg[ag], n)
        add_hg2 = _seg_acc(fr, add_x, fr.mul(eg[ag], v_dev[ay]), n)
    else:
        add_hg1 = add_hg2 = fr.zeros((n,))
    return mul_hg, add_hg1, add_hg2


def gkr_tables_phase_two(ds, eg, eru, gates, bit_size: int):
    """Device eval_fgu (ckb-zkp libra/src/evaluate.rs:105-120): accumulate over y."""
    fr = ds.fr
    n = 1 << bit_size

    def table(gs):
        if not gs:
            return fr.zeros((n,))
        vals = fr.mul(eg[_idx(fr, [g.g for g in gs])], eru[_idx(fr, [g.left_node for g in gs])])
        return _seg_acc(fr, [g.right_node for g in gs], vals, n)

    return (table([g for g in gates if g.op == 1]), table([g for g in gates if g.op == 0]))


# below this table length the host-int path is faster than device dispatch
# and transfers (and unit tests never pay device work)
DEVICE_SUMCHECK_MIN = 1 << 11

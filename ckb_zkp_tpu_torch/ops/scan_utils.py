"""Scan helpers: the parts of the reference's `ops/scan_utils.py` the
port uses.

`hs_scan` ports `scan_utils.hs_scan` (`:155`), with the scanned axis as an
argument so the MSM can scan a batch of windows at once.
`prefix_at_indices` ports `:182-255` for the Jacobian MSM engine, with
its within-block step shared as `within_block_prefix`. `SegmentLayout`
and `segment_sum` take the place of `segment_sum_sorted` (`:67`) for the
sparse products: torch has no modular segment sum, so the segments are
grouped by length class (lengths in (2^(c-1), 2^c]), each class is laid
out as a zero-padded (segments, 2^c) block and reduced with c rounds of
the field `add`. A block is at most twice its entries, so the memory and
work of a segment sum grow with the number of entries, however long the
longest segment (the ONE column of a real R1CS holds a large share of
them).
"""

from __future__ import annotations

import numpy as np
import torch


def hs_scan(combine, elems, dim: int = 0):
    """Inclusive scan along `dim` by Hillis-Steele distance doubling:
    ceil(log2 n) full-width combiner calls. elems: tuple of tensors."""
    n = elems[0].shape[dim]
    if n == 1:
        return elems
    idx = torch.arange(n, device=elems[0].device)
    v = tuple(elems)
    d = 1
    while d < n:
        prev = tuple(torch.roll(x, d, dims=dim) for x in v)
        comb = combine(prev, v)
        ok = (idx >= d).reshape((n,) + (1,) * (v[0].dim() - dim - 1))
        v = tuple(torch.where(ok, a, b) for a, b in zip(comb, v))
        d *= 2
    return v


def _mask(mask, a, b):
    """where(mask, a, b) over tuples, the mask broadcast over trailing dims."""
    return tuple(torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())), x, y)
                 for x, y in zip(a, b))


def _bcast(identity, shape):
    return tuple(i.expand(*shape, *i.shape) for i in identity)


def _take_rows(elems, idx):
    """elems (k, n, ...) gathered per row at idx (k, ...) -> (k, ...)."""
    rows = torch.arange(idx.shape[0], device=idx.device).reshape(-1, *[1] * (idx.dim() - 1))
    return tuple(x[rows, idx] for x in elems)


def within_block_prefix(combine, elems, identity, gq, r, block: int, promote=None):
    """For each query, the combine of rows gq*block .. gq*block + r of
    elems: the query's rows are gathered (promoted, if given), those past
    r masked to the identity, and reduced by a Hillis-Steele scan over the
    block axis. elems (k, n, ...), gq and r (k, Q) -> (k, Q, ...). The
    reference's `_within_block_partial` (`ops/msm.py:651-668`) and the
    same step of `prefix_at_indices`."""
    ar = torch.arange(block, device=gq.device)
    rows = _take_rows(elems, gq.unsqueeze(-1) * block + ar)  # (k, Q, block, ...)
    if promote is not None:
        rows = promote(rows)
    keep = ar <= r.unsqueeze(-1)
    masked = _mask(keep, rows, _bcast(identity, keep.shape))
    return tuple(x[:, :, -1] for x in hs_scan(combine, masked, dim=2))


def prefix_at_indices(combine, elems, identity, q, block: int = 32,
                      hs_base: int = 1024, leaf_combine=None,
                      leaf_identity=None, promote=None):
    """Inclusive prefix-combine of elems[j, 0..q_ji] for each query index
    (q_ji = -1 gives the identity), for a batch of k rows: elems (k, n,
    ...), q (k, Q) -> (k, Q, ...). Block totals by a loop of `block`
    combines, their prefix recursively, and each query's within-block
    rows; a Hillis-Steele scan at n <= hs_base. With `leaf_combine`, elems
    are leaves in a cheaper representation: the first level's totals use
    leaf_combine(acc, leaf), `leaf_identity` pads the leaves and
    `promote` lifts them for the within-block step. Reference:
    `ops/scan_utils.py:182-255` (one row)."""
    k, n = elems[0].shape[:2]
    leaf = leaf_combine is not None
    ident_q = _bcast(identity, q.shape)
    qc = q.clamp(min=0)
    if n <= hs_base:
        pref = hs_scan(combine, promote(elems) if leaf else elems, dim=1)
        return _mask(q >= 0, _take_rows(pref, qc.clamp(max=n - 1)), ident_q)
    g = -(-n // block)
    pad = _bcast(leaf_identity if leaf else identity, (k, g * block - n))
    padded = tuple(torch.cat([x, i.to(x.dtype)], dim=1) for x, i in zip(elems, pad))
    moved = tuple(x.reshape(k, g, block, *x.shape[2:]) for x in padded)
    acc = _bcast(identity, (k, g))
    step = leaf_combine if leaf else combine
    for b in range(block):
        acc = step(acc, tuple(x[:, :, b] for x in moved))
    gq = torch.div(qc, block, rounding_mode="floor")
    before = prefix_at_indices(combine, acc, identity, gq - 1, block, hs_base)
    part2 = within_block_prefix(combine, padded, identity, gq, qc - gq * block,
                                block, promote if leaf else None)
    return _mask(q >= 0, combine(before, part2), ident_q)


class SegmentLayout:
    """How the entries of a COO view sum into their segments.

    `order` sorts the entries by (length class, segment), stably; in that
    order each class is one contiguous run of entries. `classes` holds one
    (start, end, width, segs, row, pos) per class present: its entries
    [start, end), its block width 2^c, its segment ids in order and each
    entry's block row and position."""

    def __init__(self, seg, num_segments: int, device):
        seg = np.asarray(seg, dtype=np.int64)
        self.num_segments = num_segments
        n = seg.size
        counts = np.bincount(seg, minlength=num_segments)
        cls = np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64)
        self.order = np.lexsort((np.arange(n), seg, cls[seg]))
        s = seg[self.order]
        first = np.ones(n, dtype=bool)
        first[1:] = s[1:] != s[:-1]
        pos = np.arange(n) - np.maximum.accumulate(np.where(first, np.arange(n), 0))
        ends = np.searchsorted(cls[s], np.arange(int(cls.max(initial=0)) + 2))
        self.classes = []
        self.block_rows = 0  # sum of segments x width over the blocks
        for c in range(len(ends) - 1):
            start, end = int(ends[c]), int(ends[c + 1])
            if start == end:
                continue
            segs = np.flatnonzero((cls == c) & (counts > 0))
            row = np.searchsorted(segs, s[start:end])
            self.block_rows += segs.size << c
            self.classes.append((start, end, 1 << c) + tuple(
                torch.as_tensor(a, device=device) for a in (segs, row, pos[start:end])))


def segment_sum(df, vals, layout: SegmentLayout):
    """out[s] = sum of the entries of segment s, mod p; (num_segments, L).
    vals: (nnz, L), in `layout.order`."""
    out = df.zeros((layout.num_segments,))
    for start, end, width, segs, row, pos in layout.classes:
        block = df.zeros((segs.numel(), width))
        block[row, pos] = vals[start:end]
        while block.shape[1] > 1:
            block = df.add(block[:, 0::2], block[:, 1::2])
        out[segs] = block[:, 0]
    return out

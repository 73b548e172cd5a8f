"""Scan helpers: the parts of the reference's `ops/scan_utils.py` the
port uses.

`hs_scan` ports `scan_utils.hs_scan` (`:155`), with the scanned axis as an
argument so the MSM can scan a batch of windows at once. `SegmentLayout`
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

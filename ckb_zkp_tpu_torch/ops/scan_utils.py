"""Scan helpers: the parts of the reference's `ops/scan_utils.py` the
prover slice uses.

`hs_scan` ports `scan_utils.hs_scan` (`:155`), with the scanned axis as an
argument so the MSM can scan a batch of windows at once. `row_sum` takes
the place of `segment_sum_sorted` (`:67`) for the sparse matvec: torch has
no modular segment sum, so each row's entries are laid out in an (m, k)
block (k the longest row, zero padded) and reduced with log2(k) rounds of
the field `add`.
"""

from __future__ import annotations

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


def row_layout(rows, num_rows: int):
    """Sorted-by-row COO rows -> (position within row, k = longest row)."""
    rows = torch.as_tensor(rows, dtype=torch.int64)
    if rows.numel() == 0:
        return rows, 1
    counts = torch.bincount(rows, minlength=num_rows)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(rows.numel()) - starts[rows]
    return pos, max(1, int(counts.max()))


def row_sum(df, vals, rows, pos, num_rows: int, k: int):
    """out[r] = sum of vals over entries of row r, mod p. vals: (nnz, L)."""
    block = df.zeros((num_rows, k))
    block[rows, pos] = vals
    while block.shape[1] > 1:
        if block.shape[1] % 2:
            block = torch.cat([block, df.zeros((num_rows, 1))], dim=1)
        block = df.add(block[:, 0::2], block[:, 1::2])
    return block[:, 0]

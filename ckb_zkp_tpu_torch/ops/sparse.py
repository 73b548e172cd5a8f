"""Sparse matrices over Fr: y = M @ z and y = M^T @ z for the QAP.

Port of the reference's `ops/sparse.py` (`:23-110`): `COL_ALIGN`,
`aligned_cols`, `DeviceCoo.matvec` (the prover's witness map) and the
transpose products `rmatvec` / `rmatvec_padded` (the setup's instance map).
Each product is a gather, a K1 multiply by the coefficients and an exact
per-segment sum mod p (`scan_utils.segment_sum`, whose cost grows with the
number of entries) over the row view (M z) or the column view (M^T z).
"""

from __future__ import annotations

import numpy as np
import torch

from .field import DeviceField
from .scan_utils import SegmentLayout, segment_sum

# Query/column arrays pad to the MSM scan tile alignment (32 x 8 x 128)
# once they exceed it, and to a power of two below (the reference's rule).
COL_ALIGN = 32 * 8 * 128


def aligned_cols(n: int) -> int:
    """Shared column-padding rule: pow2 below COL_ALIGN, COL_ALIGN-multiple
    above (always <= the pow2 padding)."""
    pow2 = max(8, 1 << max(0, n - 1).bit_length())
    return min(pow2, -(-n // COL_ALIGN) * COL_ALIGN)


class _SortedView:
    """COO entries grouped by one key (`SegmentLayout`): the gather index
    and the coefficient of each entry, in the layout's order."""

    def __init__(self, df: DeviceField, seg, other, coeffs, num_segments: int):
        self.layout = SegmentLayout(seg, num_segments, df.device)
        order = self.layout.order
        self.gather = torch.as_tensor(other[order], device=df.device)
        if coeffs and all(c == 1 for c in coeffs):
            # the common unit coefficient: one broadcast Montgomery one
            self.coeffs = df.ones((1,))
        else:
            self.coeffs = df.encode([coeffs[i] for i in order])

    def apply(self, df: DeviceField, z: torch.Tensor) -> torch.Tensor:
        vals = df.mul(z[self.gather], self.coeffs)
        return segment_sum(df, vals, self.layout)


class DeviceCoo:
    """COO matrix with device index tensors; supports M @ z and M^T @ z."""

    def __init__(self, df: DeviceField, rows, cols, coeffs, num_rows: int,
                 num_cols: int):
        self.df = df
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.num_cols_pad = aligned_cols(num_cols)
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        coeffs = list(coeffs)
        self.nnz = len(coeffs)
        self._rows = _SortedView(df, rows, cols, coeffs, num_rows)
        self._cols = None
        self._coo = (rows, cols, coeffs)

    @property
    def cols_view(self) -> _SortedView:
        """The column-sorted view (c_rows, c_cols, c_coeffs in the
        reference), built on the first transpose product."""
        if self._cols is None:
            rows, cols, coeffs = self._coo
            self._cols = _SortedView(self.df, cols, rows, coeffs, self.num_cols_pad)
        return self._cols

    def matvec(self, z: torch.Tensor) -> torch.Tensor:
        """z: (>= num_cols, L) Montgomery -> (num_rows, L) Montgomery."""
        if self.nnz == 0:
            return self.df.zeros((self.num_rows,))
        return self._rows.apply(self.df, z)

    def rmatvec(self, z: torch.Tensor) -> torch.Tensor:
        """z: (num_rows, L) Montgomery -> (num_cols, L) Montgomery."""
        return self.rmatvec_padded(z)[: self.num_cols]

    def rmatvec_padded(self, z: torch.Tensor) -> torch.Tensor:
        """Like rmatvec, at the padded (num_cols_pad, L) width; the padding
        columns are zero."""
        if self.nnz == 0:
            return self.df.zeros((self.num_cols_pad,))
        return self.cols_view.apply(self.df, z)

"""Sparse matrices over Fr: y = M @ z for the QAP witness map.

Port of the reference's `ops/sparse.py` (`:23-110`): `COL_ALIGN`,
`aligned_cols` and `DeviceCoo.matvec`. The product is a gather, a K1
multiply by the coefficients and an exact per-row sum mod p
(`scan_utils.row_sum`). The transpose product is not needed by the slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import DeviceField
from .scan_utils import row_layout, row_sum

# Query/column arrays pad to the MSM scan tile alignment (32 x 8 x 128)
# once they exceed it, and to a power of two below (the reference's rule).
COL_ALIGN = 32 * 8 * 128


def aligned_cols(n: int) -> int:
    """Shared column-padding rule: pow2 below COL_ALIGN, COL_ALIGN-multiple
    above (always <= the pow2 padding)."""
    pow2 = max(8, 1 << max(0, n - 1).bit_length())
    return min(pow2, -(-n // COL_ALIGN) * COL_ALIGN)


class DeviceCoo:
    """COO matrix with device index tensors; supports y = M @ z."""

    def __init__(self, df: DeviceField, rows, cols, coeffs, num_rows: int,
                 num_cols: int):
        self.df = df
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.num_cols_pad = aligned_cols(num_cols)
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        order = np.argsort(rows, kind="stable")
        rows, cols = rows[order], cols[order]
        coeffs = list(coeffs)
        self.nnz = len(coeffs)
        pos, self.k = row_layout(rows, num_rows)
        dev = df.device
        self.rows = torch.as_tensor(rows, device=dev)
        self.cols = torch.as_tensor(cols, device=dev)
        self.pos = pos.to(dev)
        if coeffs and all(c == 1 for c in coeffs):
            # the common unit coefficient: one broadcast Montgomery one
            self.coeffs = df.ones((1,))
        else:
            self.coeffs = df.encode([coeffs[i] for i in order])

    def matvec(self, z: torch.Tensor) -> torch.Tensor:
        """z: (>= num_cols, L) Montgomery -> (num_rows, L) Montgomery."""
        df = self.df
        if self.nnz == 0:
            return df.zeros((self.num_rows,))
        vals = df.mul(z[self.cols], self.coeffs)
        return row_sum(df, vals, self.rows, self.pos, self.num_rows, self.k)

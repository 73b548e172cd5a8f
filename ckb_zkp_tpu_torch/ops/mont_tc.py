"""The byte-band Montgomery reduction: its constants, the fragment table of
the tensor-core multiply (`csrc/mont_tc.cuh` `fp_mul_tc`) and its plain
version.

The card's counterpart of K7, the reference's int8 MXU reduction
(`ckb_zkp_tpu/ops/pallas_field.py:194-284`: `mxu_band_consts`,
`_band_matmul`, `_mont_reduce_cols_mxu`, `_mont_mul_rows_mxu`). The two
convolutions of the reduction by a constant operand, m = (t mod R) n' mod R
and u = m p, are products of the data's bytes with band matrices of the
constant's bytes:

    q[c] = sum_i tbyte[i] * n'byte[c - i]   (32 output columns, 32 bytes in)
    u[c] = sum_i mbyte[i] * pbyte[c - i]    (64 output columns, 32 bytes in)

q is carried into the 32 bytes of m; u is gathered into words, added to t,
and the high half, less p if needed, is the product. Every column sum is an
integer below 32 * 255^2 < 2^21, so the result is bit-equal to the CIOS
product (`csrc/field.cuh` `fp_mul`) and to the reference.

`mxu_band_consts` is a copy of the reference's (numpy only): the TPU form
with the constant bytes shifted by -128 into int8 and a kron with I_sb.
The card has u8 operands, so `band_matrices` keeps the bytes as they are
and drops the kron, a sublane device of the TPU; the column sums are the
same integers.
"""

from __future__ import annotations

import numpy as np
import torch

from .limbs import carry_propagate, product_cols

TC_TILES = 6  # m16 tiles: 2 of the n' band (32 rows), 4 of the p band (64)


def _to_bytes(limbs) -> list[int]:
    out = []
    for v in limbs:
        out.append(int(v) & 0xFF)
        out.append((int(v) >> 8) & 0xFF)
    return out


def mxu_band_consts(p_limbs, np_limbs, sb: int):
    """(M1, M2, rs1, rs2) as the reference builds them at sublane block sb:
    int8 band matrices (constant bytes - 128, kron with I_sb) and their row
    sums before the shift. Copy of `ckb_zkp_tpu/ops/pallas_field.py:194`."""
    L = len(p_limbs)
    nb = _to_bytes(np_limbs)  # 2L bytes
    pb = _to_bytes(p_limbs)
    K = 2 * L
    M1 = np.zeros((K, K), np.int32)
    for c in range(K):
        for i in range(K):
            if 0 <= c - i < K:
                M1[c, i] = nb[c - i]
    M2 = np.zeros((2 * K, K), np.int32)
    for c in range(2 * K):
        for i in range(K):
            if 0 <= c - i < K:
                M2[c, i] = pb[c - i]
    rs1 = tuple(int(x) for x in M1.sum(axis=1))
    rs2 = tuple(int(x) for x in M2.sum(axis=1))
    eye = np.eye(sb, dtype=np.int32)
    M1b = (np.kron(M1, eye) - 128).astype(np.int8)
    M2b = (np.kron(M2, eye) - 128).astype(np.int8)
    return M1b, M2b, rs1, rs2


def band_matrices(p_limbs, np_limbs):
    """The card form: M1 (2L, 2L) and M2 (4L, 2L) uint8 band matrices of
    n' and p's bytes, M[c, i] = byte[c - i]; no shift, no kron."""
    L = len(p_limbs)
    K = 2 * L
    out = []
    for limbs, rows in ((np_limbs, K), (p_limbs, 2 * K)):
        bts = _to_bytes(limbs)
        M = np.zeros((rows, K), np.uint8)
        for c in range(rows):
            for i in range(max(0, c - K + 1), min(c + 1, K)):
                M[c, i] = bts[c - i]
        out.append(M)
    return tuple(out)


def fragment_table(p_limbs, np_limbs) -> np.ndarray:
    """The A operands of `fp_mul_tc`'s mma.m16n8k32 (u8), in the order the
    lanes load them: (TC_TILES, 32 lanes, 4) uint32, tiles 0-1 the rows of
    M1, tiles 2-5 those of M2. PTX ISA fragment layout of A (16 x 32, row
    major), lane = 4 * group + tq: register 0 holds row group, columns
    4 tq .. 4 tq + 3 (the lowest byte first); register 1 row group + 8, the
    same columns; registers 2 and 3 the same rows at columns 16 + 4 tq."""
    M1, M2 = band_matrices(p_limbs, np_limbs)
    mats = np.concatenate([M1, M2]).astype(np.uint32)  # (96, 32)
    out = np.zeros((TC_TILES, 32, 4), np.uint32)
    for t in range(TC_TILES):
        for lane in range(32):
            g, tq = lane >> 2, lane & 3
            for r, (row, col) in enumerate(((g, 0), (g + 8, 0), (g, 16), (g + 8, 16))):
                b = mats[16 * t + row, col + 4 * tq : col + 4 * tq + 4]
                out[t, lane, r] = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)
    return out


_FRAGS: dict = {}


def fragments(df, device) -> torch.Tensor:
    """`fragment_table` of the field `df` as an int32 tensor on `device`
    (cached), the `frag` operand of the kernels that call `fp_mul_tc`."""
    key = (df.spec.modulus, str(torch.device(device)))
    t = _FRAGS.get(key)
    if t is None:
        tab = fragment_table(df.p_limbs, df.nprime_limbs)
        t = _FRAGS[key] = torch.as_tensor(tab.view(np.int32).copy(), device=device)
    return t


def exact_matmul(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x @ m.T for int64 tensors whose every sum stays below 2^53: int64 on
    the CPU; float64 on the card, which has no integer matmul (exact there
    for the same reason)."""
    if x.device.type == "cpu":
        return x @ m.T
    return (x.to(torch.float64) @ m.T.to(torch.float64)).to(torch.int64)


def _bytes_of(limbs: torch.Tensor) -> torch.Tensor:
    """(..., L) 16-bit limbs (int64) -> (..., 2L) bytes, lowest first."""
    return torch.stack([limbs & 0xFF, limbs >> 8], dim=-1).flatten(-2)


def _cols_to_limbs(cols: torch.Tensor) -> torch.Tensor:
    """(..., 2k) byte columns -> (..., k) lazy 16-bit columns."""
    return cols[..., 0::2] + (cols[..., 1::2] << 8)


def mont_reduce_tc_plain(df, t: torch.Tensor) -> torch.Tensor:
    """Canonical 2L int64 limbs of t < R p -> t R^-1 mod p by the byte-band
    convolutions: the arithmetic of `fp_mul_tc` in torch int64."""
    from .cuda_field import cond_sub_p

    L = df.L
    m1, m2 = (torch.as_tensor(M.astype(np.int64), device=t.device)
              for M in band_matrices(df.p_limbs, df.nprime_limbs))
    q = exact_matmul(_bytes_of(t[..., :L]), m1)  # (..., 2L) byte columns
    m = carry_propagate(_cols_to_limbs(q))  # m = t n' mod R, canonical
    u = exact_matmul(_bytes_of(m), m2)  # (..., 4L) byte columns of m p
    s = carry_propagate(t + _cols_to_limbs(u))  # low half is zero
    return cond_sub_p(df, s[..., L:])


def mont_mul_tc_plain(df, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain tensor-core Montgomery product: int32 limbs in, canonical int32
    limbs out, bit-equal to K1 (`cuda_field.mont_mul_plain`)."""
    t = carry_propagate(product_cols(a.to(torch.int64), b.to(torch.int64), 2 * df.L))
    return mont_reduce_tc_plain(df, t).to(torch.int32)

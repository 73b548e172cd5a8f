"""K1: the batched Montgomery multiply, its CUDA wrapper and plain version.

Replaces the TPU kernel `ops/pallas_field.py` `_mul_kernel` (through
`_mul_fn`, entries `mont_mul`/`mont_mul_tiles`): a * b * R^-1 mod p with
canonical output. On the H100 the kernel (`csrc/mont_mul.cu`
`mont_mul_kernel`) runs one thread per element, CIOS over NW = L / 2
32-bit words with 64-bit accumulators (an instance at 8 words: BN254 and
every Fr; one at 12: BLS12-381's Fq, which also serves its Fq2): it is
bound by the integer multiply rate (2 NW^2 32x32->64 products per
element) and reads 4 NW bytes per operand row with 16-byte vector loads.
A broadcast operand (a constant such as R^2 or a twiddle row of length
1) is read with a zero element step instead of being materialized.

The plain version follows the reference's XLA path (`ops/field.py:123-179`):
schoolbook columns, SOS reduction and one conditional subtract. Its limbs
are float64 integers below 2^53, so every sum is exact: the columns of
a * b come from L row updates (a few rows: one product with b's Toeplitz
view), m = t n' mod R and m p are matrix products with constant Toeplitz
matrices, and the carry out of the low half, an exact integer since that
half is 0 mod R, is one rounded dot product. On the CPU rows run in
blocks of PLAIN_BLOCK, whose columns stay in cache.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build
from .limbs import BASE_BITS, ks_resolve

MAXW = 12
PLAIN_BLOCK = 1 << 11  # rows of a plain K1 block on the CPU (a card takes all at once)
_FEW_ROWS = 256  # below this, a block's columns come from one Toeplitz product


def kernel_consts(df, b3_small: int = 0, b3_mont=None, b3_twist: bool = False) -> np.ndarray:
    """Flat uint32 constant block the C entries parse (`csrc/rcb.cuh`
    `parse_consts`): [nw, ninv, b3_small, p[12], one[12], b3_c0[12],
    b3_c1[12], b3_twist]. b3_small = k > 0 has the kernels multiply by 3b
    with an add chain: 3b = k, or 3b = k + k u over Fq2 with b3_twist."""
    p = df.spec.modulus
    nw = df.L // 2
    out = np.zeros(3 + 4 * MAXW + 1, dtype=np.uint32)
    out[0] = nw
    out[1] = (-pow(p, -1, 1 << 32)) % (1 << 32)
    out[2] = b3_small
    out[3 + 4 * MAXW] = int(b3_twist)
    words = lambda x: [(x >> (32 * i)) & 0xFFFFFFFF for i in range(nw)]  # noqa: E731
    out[3 : 3 + nw] = words(p)
    out[3 + MAXW : 3 + MAXW + nw] = words(df.R)
    if b3_mont is not None:
        for k, v in enumerate(b3_mont):
            base = 3 + (2 + k) * MAXW
            out[base : base + nw] = words(v)
    return out


def _operand(x: torch.Tensor, shape, L: int):
    """(tensor, element step): a single broadcast element is read with
    step 0, anything else is materialized at the output shape."""
    if tuple(x.shape) == tuple(shape) and x.is_contiguous():
        return x, 1
    if x.numel() == L:
        return x.reshape(L).contiguous(), 0
    return x.expand(shape).contiguous(), 1


def mont_mul(df, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: plain version for CPU tensors, the kernel for CUDA."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(df, a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    L = df.L
    if shape[-1] != L:
        raise ValueError(f"mont_mul: last dim {shape[-1]} != L = {L}")
    a, sa = _operand(a, shape, L)
    b, sb = _operand(b, shape, L)
    cuda_build.check_tensor(a, "mont_mul a")
    cuda_build.check_tensor(b, "mont_mul b")
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = out.numel() // L
    if n == 0:
        return out
    rc = cuda_build.lib().zkp_mont_mul(
        df.kconsts.ctypes.data, out.data_ptr(), a.data_ptr(), b.data_ptr(),
        n, sa, sb, cuda_build.stream_ptr(out),
    )
    cuda_build.count("mont_mul", df.kconsts)
    cuda_build.check(rc, "mont_mul")
    return out


def mont_mul_plain(df, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1: int32 limbs in (a * b < R p), canonical int32 out."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    L = df.L
    A = a.to(torch.float64).expand(shape).reshape(-1, L)
    B = b.to(torch.float64).expand(shape).reshape(-1, L)
    c = df.consts(A.device)
    n = A.shape[0]
    step = PLAIN_BLOCK if A.device.type == "cpu" else max(n, 1)
    if n <= step:
        return _mont_block(df, A, B, c).reshape(shape)
    out = torch.empty((n, L), dtype=torch.int32, device=A.device)
    for i in range(0, n, step):
        out[i : i + step] = _mont_block(df, A[i : i + step], B[i : i + step], c)
    return out.reshape(shape)


def _carry_f64(x: torch.Tensor, c: dict) -> torch.Tensor:
    """One carry pass over float64 integer limbs (a matrix product): each
    limb keeps its low 16 bits and hands the rest one limb up; the top
    limb's excess is dropped."""
    return torch.addmm(x, torch.floor_(x * (1.0 / (1 << BASE_BITS))), c["carry_t"])


def _product_cols(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(n, 2L) schoolbook columns of a * b (float64 limbs), each < L 2^32."""
    n, L = A.shape
    if n < _FEW_ROWS:
        Bp = torch.nn.functional.pad(B, (L, L))
        toeplitz = Bp.as_strided((n, L, 2 * L), (3 * L, 1, 1), 1)  # [j, k] = b[k + j + 1 - L]
        return (A.flip(-1).unsqueeze(-1) * toeplitz).sum(1)
    T = A.new_zeros((n, 2 * L))
    for i in range(L):
        T[:, i : i + L].addcmul_(A[:, i : i + 1], B)
    return T


def _mont_block(df, A: torch.Tensor, B: torch.Tensor, c: dict) -> torch.Tensor:
    """a * b R^-1 mod p for a block of float64 limb rows, as int32 limbs.

    t's low half, carried once (limbs < 2^22), times n' gives columns below
    2^42; two carries leave m = t n' mod R below 1.02 R, so (p < R / 2)
    t + m p < 2 R p, with columns below 2^39. The low half of t + m p is
    c R exactly; the high half plus c, carried once (limbs < 2^24), is
    h < 2p: h or h - p, resolved in one pass (`_pick`)."""
    L = A.shape[1]
    T = _product_cols(A, B)
    m = _carry_f64(_carry_f64(_carry_f64(T[:, :L], c) @ c["nprime_t"], c), c)
    T.addmm_(m, c["p_t"])
    H = T[:, L:]
    H[:, 0] += torch.round(T[:, :L] @ c["low_w"])
    return df._pick(_carry_f64(H, c).to(torch.int32), c["comp32"], False)


def cond_sub_p(df, x: torch.Tensor) -> torch.Tensor:
    """x in [0, 2p) canonical int64 limbs -> x mod p (x + ~p + 1 trick)."""
    d, ge = ks_resolve(x + df.consts(x.device)["comp_p1"])
    return torch.where(ge.unsqueeze(-1).bool(), d, x)

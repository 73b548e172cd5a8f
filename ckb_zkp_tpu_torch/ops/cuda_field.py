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

The plain version is the reference's XLA path (`ops/field.py:123-179`) in
int64: skewed schoolbook columns, flat carry resolution, SOS reduction and
one conditional subtract.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build
from .limbs import carry_pass, carry_propagate, ks_resolve, product_cols


def const_cols(a: torch.Tensor, toeplitz: torch.Tensor) -> torch.Tensor:
    """Column sums of a * constant (int64 limbs), exact in float64."""
    return (a.to(torch.float64) @ toeplitz).to(torch.int64)

MAXW = 12


def kernel_consts(df, b3_small: int = 0, b3_mont=None) -> np.ndarray:
    """Flat uint32 constant block the C entries parse:
    [nw, ninv, b3_small, p[12], one[12], b3_c0[12], b3_c1[12]]."""
    p = df.spec.modulus
    nw = df.L // 2
    out = np.zeros(3 + 4 * MAXW, dtype=np.uint32)
    out[0] = nw
    out[1] = (-pow(p, -1, 1 << 32)) % (1 << 32)
    out[2] = b3_small
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
    """Plain PyTorch K1: int32 limbs in, canonical int32 limbs out."""
    t = carry_pass(product_cols(a.to(torch.int64), b.to(torch.int64), 2 * df.L))
    return mont_reduce(df, t).to(torch.int32)


def mont_reduce(df, t: torch.Tensor) -> torch.Tensor:
    """2L int64 limbs of t < R p (each limb <= MASK + 63, not necessarily
    canonical) -> t R^-1 mod p, SOS form: m = t n' mod R; (t + m p) / R.

    m is only carry-passed, not resolved: its value stays below 1.01 R, so
    t + m p < (p/R + 1.01) R p < 2 R p and one conditional subtract ends it.
    Every float64 column sum stays below 2^37, so the products are exact."""
    L = df.L
    c = df.consts(t.device)
    m = carry_pass(const_cols(t[..., :L], c["nprime_t"][:, :L]))
    s = carry_propagate(const_cols(m, c["p_t"]) + t)  # low half is zero
    return cond_sub_p(df, s[..., L:])


def cond_sub_p(df, x: torch.Tensor) -> torch.Tensor:
    """x in [0, 2p) canonical int64 limbs -> x mod p (x + ~p + 1 trick)."""
    d, ge = ks_resolve(x + df.consts(x.device)["comp_p1"])
    return torch.where(ge.unsqueeze(-1).bool(), d, x)

"""Limb representation of big integers, numpy <-> torch.

Port of the reference's `ops/limbs.py:26-70`. Field elements are
``(..., L)`` arrays of 16-bit little-endian limbs with ``L = 4 *
ceil(bits/64)`` (16 for BN254), so the Montgomery radix ``R = 2^(16 L)``
matches arkworks' (2^256 for BN254). numpy arrays are ``uint32`` as in
the reference; torch tensors are ``int32`` (16-bit limbs fit, and torch's
CPU build lacks ``uint32`` arithmetic). Kernels read two limbs as one
32-bit word (`pack_limbs`): the same integer, so the same Montgomery form.
"""

from __future__ import annotations

import numpy as np
import torch

BASE_BITS = 16
BASE = 1 << BASE_BITS
MASK = BASE - 1


def nlimbs_for(bits: int) -> int:
    """Limb count: arkworks' 64-bit limb count x4."""
    return (bits + 63) // 64 * 4


def int_to_limbs(x: int, nlimbs: int) -> np.ndarray:
    """Python int -> little-endian 16-bit limb array (numpy uint32)."""
    out = np.zeros(nlimbs, dtype=np.uint32)
    for i in range(nlimbs):
        out[i] = x & MASK
        x >>= BASE_BITS
    assert x == 0, "integer does not fit in limb count"
    return out


def ints_to_limbs(xs, nlimbs: int) -> np.ndarray:
    """Iterable of ints -> (N, L) uint32 array, through one bytes buffer."""
    xs = list(xs)
    buf = b"".join(int(x).to_bytes(nlimbs * 2, "little") for x in xs)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(xs), nlimbs)
    return arr.astype(np.uint32)


def limbs_to_ints(arr) -> list[int]:
    """(N, L) limb array (numpy or torch) -> list of Python ints."""
    arr = np.asarray(to_numpy(arr) if isinstance(arr, torch.Tensor) else arr)
    flat = arr.reshape(-1, arr.shape[-1]).astype("<u2")
    nbytes = arr.shape[-1] * 2
    raw = flat.tobytes()
    return [
        int.from_bytes(raw[i * nbytes : (i + 1) * nbytes], "little")
        for i in range(flat.shape[0])
    ]


def to_torch(arr, device="cuda") -> torch.Tensor:
    """numpy/array-like uint32 16-bit limbs -> int32 tensor on `device`."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> numpy uint32 (the reference's dtype)."""
    return t.detach().cpu().numpy().view(np.uint32)


def pack_limbs(limbs: torch.Tensor) -> torch.Tensor:
    """(n, R) 16-bit limbs -> (n, R/2) 32-bit words, limb 2i | limb 2i+1 << 16.

    The words are int32 tensors holding the uint32 bit pattern (bit 31 may
    be set). Reference: `pallas_rcb.pack_limbs` (`ops/pallas_rcb.py:609`).
    """
    lo = limbs[..., 0::2].to(torch.int64)
    hi = limbs[..., 1::2].to(torch.int64)
    return _u32_to_i32(lo | (hi << 16))


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """(n, R/2) 32-bit words -> (n, R) 16-bit limbs (int64)."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & MASK, w >> 16], dim=-1).flatten(-2)


def _u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


# ---------------------------------------------------------------------------
# int64 limb arithmetic for the plain PyTorch paths. A port of the
# reference's flat carry machinery (`ops/limbs.py:78-129`): no data-dependent
# loops, so the same op sequence runs on CPU and CUDA tensors.

def _aranges(nl: int, device, dtype):
    """(arange(nl), 2^arange(nl)) on `device`, cached."""
    key = (nl, str(device), dtype)
    t = _ARANGE_CACHE.get(key)
    if t is None:
        ar = torch.arange(nl, dtype=torch.int64)
        t = _ARANGE_CACHE[key] = (ar.to(device, dtype), (1 << ar).to(device, dtype))
    return t


_ARANGE_CACHE: dict = {}


def ks_resolve(t: torch.Tensor):
    """Resolve 1-bit carries: t int32 or int64 (..., nl), every limb
    <= 2*MASK + 1.

    Returns (canonical limbs, carry_out). The carry recurrence
    c_{i+1} = g_i | (p_i & c_i) is the carry vector of the integer sum
    G + (G | P) over the bit-packed masks (g = limb overflow, p = limb ==
    MASK), recovered as S ^ G ^ (G | P). The masks fit one word: nl <= 30
    for int32, nl <= 62 for int64.
    """
    nl = t.shape[-1]
    assert nl <= (30 if t.dtype == torch.int32 else 62)
    ar, w = _aranges(nl, t.device, t.dtype)
    G = ((t >> BASE_BITS) * w).sum(-1, dtype=t.dtype)
    P = (((t & MASK) == MASK) * w).sum(-1, dtype=t.dtype)
    GP = G | P
    c = (G + GP) ^ G ^ GP  # bit i = carry into limb i
    cb = (c.unsqueeze(-1) >> ar) & 1
    return (t + cb) & MASK, (c >> nl) & 1


def carry_pass(x: torch.Tensor, passes: int = 2) -> torch.Tensor:
    """Lazy int64 limbs (< 2^40) -> limbs <= MASK + 63 with the same value
    mod 2^(16 nl): each pass moves every limb's high part one limb up."""
    for _ in range(passes):
        hi = x >> BASE_BITS
        x = x & MASK
        x[..., 1:] += hi[..., :-1]
    return x


def carry_propagate(x: torch.Tensor) -> torch.Tensor:
    """Lazy int64 limbs (< 2^40) -> canonical 16-bit limbs; carries beyond
    the top limb are dropped (the value is taken mod 2^(16 nl))."""
    out, _ = ks_resolve(carry_pass(x))
    return out


_SKEW_CACHE: dict = {}


def _skew_matrix(L: int, device) -> torch.Tensor:
    """(L*L, 2L) 0/1 float64 matrix sending outer-product entry (i, j) to
    column i + j."""
    key = (L, str(device))
    m = _SKEW_CACHE.get(key)
    if m is None:
        i = torch.arange(L * L)
        m = torch.zeros(L * L, 2 * L, dtype=torch.float64)
        m[i, i // L + i % L] = 1.0
        m = _SKEW_CACHE[key] = m.to(device)
    return m


def toeplitz_cols(limbs, device) -> torch.Tensor:
    """(L, 2L) float64 matrix T with a @ T = column sums of a * c, for a
    constant c given by its limbs."""
    c = torch.as_tensor([int(v) for v in limbs], dtype=torch.float64)
    L = c.shape[0]
    t = torch.zeros(L, 2 * L, dtype=torch.float64)
    for i in range(L):
        t[i, i : i + L] = c
    return t.to(device)


def product_cols(a: torch.Tensor, b: torch.Tensor, ncols: int) -> torch.Tensor:
    """Schoolbook column sums of a * b (int64 limbs), columns [0, ncols).

    The (L, L) outer product is summed along anti-diagonals by one float64
    matrix product: every partial sum is an integer below 2^37, so float64
    is exact on CPU and CUDA alike."""
    L = a.shape[-1]
    outer = a.to(torch.float64).unsqueeze(-1) * b.to(torch.float64).unsqueeze(-2)
    lead = outer.shape[:-2]
    cols = outer.reshape(-1, L * L) @ _skew_matrix(L, a.device)[:, :ncols]
    return cols.reshape(*lead, ncols).to(torch.int64)

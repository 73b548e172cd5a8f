"""Measurement helpers of the probes and of `chip_smoke.py`: the card's
name and power limit, its 32-bit multiply rate, a kernel's bound, timing
by CUDA events, and random field elements drawn on the device.

A bound is the least time the card could take for a kernel's work: the
larger of its bytes (each input read once, each output written once; an
Fq element is 16 int32 limbs, 64 B) over 3.35 TB/s and its 32-bit
multiply instructions (an 8-word CIOS product is 2 * 8^2 + 8 word
products, each a low and a high IMAD; Fq2 is 3 Fq products) over 64 IMAD
per SM per clock at the SM's maximum clock.
"""

from __future__ import annotations

import subprocess
import sys

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
IMAD_PER_SM_CLOCK = 64  # CUDA Programming Guide, compute capability 9.0
FQ_BYTES = 64  # 16 int32 limbs
IMAD_PER_FQ_MUL = 2 * (2 * 8 * 8 + 8)  # CIOS over 8 words, low + high IMAD
_RATE: dict = {}


def smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def require_card(prog: str) -> bool:
    """True with a CUDA card; else a message on stderr and False."""
    if torch.cuda.is_available():
        return True
    print(f"{prog}: torch.cuda.is_available() is False; this runs only on a "
          f"CUDA card", file=sys.stderr)
    return False


def fq_muls(formula: str, ext: int) -> int:
    """Fq multiplies of one Alg. 7 add (12) or Alg. 8 mixed add (11); over
    Fq2 the two multiplies by 3b are Fq2 products too (G1's 3b = 9 is an add
    chain), and an Fq2 product is 3 Fq products. The Jacobian add's general
    branch ("jadd", `_add_core`) has 16, the mixed add's ("jmadd") 11, with
    no curve constant."""
    if formula in ("jadd", "jmadd"):
        return {"jadd": 16, "jmadd": 11}[formula] * (3 if ext == 2 else 1)
    base = {"add": 12, "madd": 11}[formula]
    return 3 * (base + 2) if ext == 2 else base


def imad_rate() -> dict:
    """The card's 32-bit multiply rate at its maximum SM clock."""
    if not _RATE:
        mhz = float(smi("clocks.max.sm").split()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _RATE.update(sms=sms, sm_mhz=mhz, imad_per_s=IMAD_PER_SM_CLOCK * sms * mhz * 1e6)
    return _RATE


def bound(nbytes: float, imads: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / imad_rate()["imad_per_s"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events, after a warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a, b) -> int:
    """Largest limb difference over tuples of int32 tensors (0 = bit-equal)."""
    if not isinstance(a, (tuple, list)):
        a, b = (a,), (b,)
    return max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b))


def rand_field(rng, n: int, shape_tail, df, device="cuda"):
    """n random canonical field elements (limbs below p's top limb), drawn
    on `device` by a generator seeded from the numpy generator `rng`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 62)))
    shape = (n, *shape_tail[:-1], df.L)
    arr = torch.randint(0, 1 << 16, shape, generator=gen, device=device, dtype=torch.int32)
    arr[..., -1] = torch.randint(0, int(df.p_limbs[-1]), shape[:-1], generator=gen,
                                 device=device, dtype=torch.int32)
    return arr

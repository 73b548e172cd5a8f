"""Build and load the port's CUDA kernels; their launch counters.

The sources under ``ckb_zkp_tpu_torch/csrc/`` (one per kernel family) have
a plain C interface: ``nvcc`` compiles each for ``sm_90a`` into an object,
all at once in parallel (``--split-compile=0`` also spreads the kernel
instances of one source over threads), and links them into one shared
library loaded with ctypes (no PyTorch headers, so a build takes seconds,
not minutes).
The build runs at first use into ``ckb_zkp_tpu_torch/_build/``, keyed by a
hash of the sources, so a checkout builds its own kernels. There is no
fallback: a missing ``nvcc`` or a failed build raises.

``COUNTS`` holds one integer per kernel wrapper; a wrapper adds one where
it launches its kernel, and nowhere else (`count`). ``ORDERED`` counts the
launches of K2 and K9b that read their leaves through an order (the MSMs'
all do). ``WIDE`` counts, beside ``COUNTS``, the launches of K1-K6's
12-word instances (BLS12-381's Fq and Fq2; the 8-word ones serve BN254 and
every Fr), so that a run can tell which instance ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("rcb_team_scan.cu", "rcb_fixed_base.cu", "rcb_scan.cu", "ec_scan.cu",
           "probe_scan.cu", "probe_mxu.cu", "probe_grid.cu", "probe_dma.cu", "ec_add.cu",
           "ec_fixed_base.cu", "ec_madd.cu", "rcb_add.cu", "rcb_madd.cu", "mont_mul.cu")
HEADERS = ("field.cuh", "rcb.cuh", "rcb_team.cuh", "ec_jac.cuh", "ec_team.cuh", "mont_tc.cuh",
           "probe.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

COUNTS = {
    "mont_mul": 0,  # K1
    "scan_prefix_madd": 0,  # K2
    "scan_prefix_add": 0,  # K3
    "scan_total_add": 0,  # K4
    "rcb_add": 0,  # K5
    "rcb_madd": 0,  # K6, elementwise
    "rcb_fixed_base": 0,  # K6, the fixed-base MSM
    "ec_add": 0,  # K8
    "ec_add_chain": 0,  # K8, the window folds' chain
    "ec_madd": 0,  # K9a, elementwise
    "ec_fixed_base": 0,  # K9a, the fixed-base MSM
    "ec_block_totals_madd": 0,  # K9b
    "ec_block_totals_add": 0,  # K9c
    "scan_prefix_madd_unpacked": 0,  # K2a
    "scan_prefix_madd_packed": 0,  # K2b
    "probe_madd_totals": 0,  # P-tot
    "probe_madd_prefix_packed": 0,  # P-prepk
    "probe_chain_mul": 0,  # P-chain
    "probe_gmajor_totals": 0,  # P12
    "probe_gmajor_prefix": 0,  # P13
    "probe_u32_ops": 0,  # P14
    "probe_band_mma": 0,  # P15
    "probe_mul_chain_cios": 0,  # P16
    "probe_mul_chain_tc": 0,  # P17
    "probe_gmajor_totals_tc": 0,  # P18
    "probe_madd_totals_tc": 0,  # P19
    "probe_grid_totals": 0,  # P7
    "probe_grid_prefix": 0,  # P8
    "probe_wo_steps": 0,  # P9
    "probe_wo_tile": 0,  # P10
    "probe_grid_prefix_tile": 0,  # P11
    "probe_xor_flat": 0,  # P20
    "probe_xor_lead1": 0,  # P21
    "probe_xor_grid2d": 0,  # P22
}

ORDERED = {"scan_prefix_madd": 0, "ec_block_totals_madd": 0}  # launches given an order
# launches of the 12-word instances (consts[0] = 12) of K1-K6
WIDE = {"mont_mul": 0, "scan_prefix_madd": 0, "scan_prefix_add": 0, "scan_total_add": 0,
        "rcb_add": 0, "rcb_fixed_base": 0}

_lib = None
BUILD_INFO: dict = {}


def reset_counts() -> None:
    for counts in (COUNTS, ORDERED, WIDE):
        for k in counts:
            counts[k] = 0


def count(name: str, kconsts) -> None:
    """One launch of kernel `name` with the constant block `kconsts`
    (`cuda_field.kernel_consts`, whose first word is the word count)."""
    COUNTS[name] += 1
    if int(kconsts[0]) == 12 and name in WIDE:
        WIDE[name] += 1


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def compile_command(source: str, obj_path: str) -> list[str]:
    return [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "--split-compile=0",
        "--resource-usage",
        "-Xcompiler", "-fPIC", "-c", "-o", obj_path,
        os.path.join(CSRC_DIR, source),
    ]


def link_command(objs: list[str], out_path: str) -> list[str]:
    return [_nvcc(), *ARCH_FLAGS, "-shared", "-o", out_path, *objs]


def build() -> str:
    """Compile the kernels if this source hash has no library yet: one
    nvcc per source, all started together, then one link."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    key = _source_hash()
    so = os.path.join(BUILD_DIR, f"libzkp_kernels_{key}.so")
    if os.path.exists(so):
        BUILD_INFO.update(path=so, seconds=0.0, cached=True)
        return so
    if not os.path.exists(_nvcc()):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    tag = f"{key}.{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{s}.{tag}.o") for s in SOURCES]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(compile_command(s, o), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for s, o in zip(SOURCES, objs)
    ]
    logs, failed = [], []
    for s, p in zip(SOURCES, procs):
        out = p.communicate()[0]
        logs.append(f"== {s} ({time.perf_counter() - t0:.1f} s)\n{out}")
        if p.returncode != 0:
            failed.append(s)
    tmp = f"{so}.{os.getpid()}.tmp"
    if not failed:
        res = subprocess.run(link_command(objs, tmp), capture_output=True, text=True)
        logs.append("== link\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append("link")
    secs = time.perf_counter() - t0
    log = "\n".join(logs)
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(log)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log[-4000:]}")
    os.replace(tmp, so)
    BUILD_INFO.update(path=so, seconds=secs, cached=False, log=log)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(build())
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        L.zkp_mont_mul.argtypes = [vp, vp, vp, vp, ll, i, i, vp]
        L.zkp_mont_mul.restype = i
        L.zkp_rcb_add.argtypes = [vp, i] + [vp] * 9 + [ll, vp]
        L.zkp_rcb_add.restype = i
        L.zkp_rcb_madd.argtypes = [vp, i] + [vp] * 9 + [ll, vp]
        L.zkp_rcb_madd.restype = i
        L.zkp_rcb_fixed_base.argtypes = [vp, i] + [vp] * 6 + [ll, vp]
        L.zkp_rcb_fixed_base.restype = i
        L.zkp_rcb_scan.argtypes = [vp, i, i] + [vp] * 10 + [ll, i, vp]
        L.zkp_rcb_scan.restype = i
        L.zkp_rcb_team_block.argtypes = [i, ll]
        L.zkp_rcb_team_block.restype = i
        L.zkp_rcb_team_lanes.argtypes = [i, ll]
        L.zkp_rcb_team_lanes.restype = i
        L.zkp_ec_add.argtypes = [vp, i, i] + [vp] * 9 + [ll, vp]
        L.zkp_ec_add.restype = i
        L.zkp_ec_add_chain.argtypes = [vp, i] + [vp] * 9 + [ctypes.c_char_p, i, ll, vp]
        L.zkp_ec_add_chain.restype = i
        L.zkp_ec_fixed_base.argtypes = [vp, i] + [vp] * 6 + [ll, vp]
        L.zkp_ec_fixed_base.restype = i
        L.zkp_ec_madd.argtypes = [vp, i] + [vp] * 9 + [ll, vp]
        L.zkp_ec_madd.restype = i
        L.zkp_ec_scan.argtypes = [vp, i] + [vp] * 7 + [ll, i, vp]
        L.zkp_ec_scan.restype = i
        L.zkp_ec_add_totals.argtypes = [vp, i] + [vp] * 6 + [ll, i, vp]
        L.zkp_ec_add_totals.restype = i
        L.zkp_probe_madd_scan.argtypes = [vp, vp] + [i] * 6 + [vp] * 9 + [ll, i, vp]
        L.zkp_probe_madd_scan.restype = i
        L.zkp_probe_chain_mul.argtypes = [vp, i, i, vp, vp, ll, i, vp]
        L.zkp_probe_chain_mul.restype = i
        L.zkp_probe_u32_ops.argtypes = [i, vp, vp, ll, vp]
        L.zkp_probe_u32_ops.restype = i
        L.zkp_probe_band_mma.argtypes = [i, vp, vp, vp, i, vp]
        L.zkp_probe_band_mma.restype = i
        L.zkp_probe_mul_chain.argtypes = [vp, vp, i, i, vp, vp, vp, ll, vp]
        L.zkp_probe_mul_chain.restype = i
        L.zkp_probe_grid_scan.argtypes = [vp] + [i] * 3 + [vp] * 9 + [ll, i, vp]
        L.zkp_probe_grid_scan.restype = i
        L.zkp_probe_wo.argtypes = [i, i] + [vp] * 5 + [ll, i, vp]
        L.zkp_probe_wo.restype = i
        L.zkp_probe_xor.argtypes = [i, i, i, vp, vp, vp, i, ll, vp]
        L.zkp_probe_xor.restype = i
        _lib = L
    return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {rc})")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(t, name: str, shape=None, dtype=None) -> None:
    """Kernel operands: contiguous, on CUDA, of `dtype` (int32 limb rows by
    default, which must also be 16-byte aligned for the vector loads)."""
    import torch

    dtype = torch.int32 if dtype is None else dtype
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if dtype == torch.int32 and t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")

"""Build and load the port's CUDA kernels; their launch counters.

The sources under ``ckb_zkp_tpu_torch/csrc/`` compile with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
ctypes (no PyTorch headers, so a build takes seconds, not minutes). The
build runs at first use into ``ckb_zkp_tpu_torch/_build/``, keyed by a hash
of the sources, so a checkout builds its own kernels. There is no fallback:
a missing ``nvcc`` or a failed build raises.

``COUNTS`` holds one integer per kernel wrapper; a wrapper adds one where
it launches its kernel, and nowhere else.
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
SOURCES = ("zkp_kernels.cu",)
HEADERS = ("field.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

COUNTS = {
    "mont_mul": 0,  # K1
    "scan_prefix_madd": 0,  # K2
    "scan_prefix_add": 0,  # K3
    "scan_total_add": 0,  # K4
    "rcb_add": 0,  # K5
}

_lib = None
BUILD_INFO: dict = {}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def build_command(out_path: str) -> list[str]:
    return [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "--resource-usage",
        "-shared", "-Xcompiler", "-fPIC", "-o", out_path,
        *(os.path.join(CSRC_DIR, s) for s in SOURCES),
    ]


def build() -> str:
    """Compile the kernels if this source hash has no library yet."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libzkp_kernels_{_source_hash()}.so")
    if os.path.exists(so):
        BUILD_INFO.update(path=so, seconds=0.0, cached=True)
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = build_command(tmp)
    if not os.path.exists(cmd[0]):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    log = res.stdout + res.stderr
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + log)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log[-4000:]}")
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
        L.zkp_rcb_scan.argtypes = [vp, i, i] + [vp] * 9 + [ll, i, vp]
        L.zkp_rcb_scan.restype = i
        _lib = L
    return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {rc})")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(t, name: str, shape=None) -> None:
    """Kernel operands: int32, contiguous, on CUDA, 16-byte aligned."""
    import torch

    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: expected int32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")

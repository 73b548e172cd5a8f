"""Native (C++) verifier bindings.

The port of `ckb_zkp_tpu/native/__init__.py`: the reference ships its
verifiers as native no_std RISC-V contracts run by CKB-VM, and the repo's
`native/groth16_bn254.cc` and `native/marlin_bn254.cc` are their native
counterparts. They are read, never edited: g++ compiles them at first use
into ``ckb_zkp_tpu_torch/_build/``, keyed by a hash of the sources (as
`transcript/merlin.py` builds `strobe.c`), and ctypes drives the library.
Same cell-data semantics and error codes as `contracts`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
# marlin_bn254.cc #includes groth16_bn254.cc, so one .so carries both the
# groth16 and marlin verifiers (shared BN254 tower, single build)
_SRC = _NATIVE_DIR / "marlin_bn254.cc"
_SRC_DEPS = (_NATIVE_DIR / "groth16_bn254.cc",)

_lib = None
_lib_err: str | None = None


class NativeUnavailable(RuntimeError):
    pass


def _build() -> Path:
    from ..ops.cuda_build import BUILD_DIR

    src = _SRC.read_bytes() + b"".join(d.read_bytes() for d in _SRC_DEPS)
    tag = hashlib.sha256(src).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = Path(BUILD_DIR) / f"libckb_zkp_native_{tag}.so"
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
        str(_SRC), "-o", str(tmp),
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def _load():
    global _lib, _lib_err
    if _lib is not None:
        return _lib
    if _lib_err is not None:
        raise NativeUnavailable(_lib_err)
    try:
        path = _build()
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.CalledProcessError) as e:
        _lib_err = f"native verifier unavailable: {e}"
        raise NativeUnavailable(_lib_err) from e
    lib.groth16_verify_bn254.restype = ctypes.c_int
    lib.groth16_verify_bn254.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.groth16_bn254_selftest.restype = ctypes.c_int
    lib.groth16_bn254_selftest.argtypes = []
    lib.marlin_verify_bn254.restype = ctypes.c_int
    lib.marlin_verify_bn254.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.marlin_bn254_selftest.restype = ctypes.c_int
    lib.marlin_bn254_selftest.argtypes = []
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def selftest() -> int:
    """0 on success; nonzero identifies the failing pairing property."""
    return int(_load().groth16_bn254_selftest())


def groth16_verify_bn254(vk: bytes, proof: bytes, publics: bytes) -> int:
    """Cell-data verify: 0 = accept, 1 = encoding error, 2 = reject."""
    lib = _load()
    return int(
        lib.groth16_verify_bn254(vk, len(vk), proof, len(proof), publics, len(publics))
    )


def marlin_selftest() -> int:
    """0 on success; nonzero identifies the failing component."""
    return int(_load().marlin_bn254_selftest())


def marlin_verify_bn254(vk: bytes, proof: bytes, publics: bytes) -> int:
    """Cell-data Marlin verify: 0 = accept, 1 = encoding error, 2 = reject.

    Same cells as contracts.universal_marlin_verifier (reference:
    universal_marlin_verifier/src/entry.rs): ivk, proof, publics in ark-0.2
    compressed encodings."""
    lib = _load()
    return int(
        lib.marlin_verify_bn254(vk, len(vk), proof, len(proof), publics, len(publics))
    )

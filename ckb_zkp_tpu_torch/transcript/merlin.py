"""Merlin-compatible transcript (STROBE-128 over Keccak-f[1600]).

Byte-compatible with the `merlin` crate used by the reference's DL-based
schemes (bulletproofs/spartan/libra/hyrax — e.g.
ckb-zkp bulletproofs/src/arithmetic_circuit.rs:315,
ckb-zkp spartan/src/prover.rs:117). Byte-compatibility is required
for proof interop: challenges derive from these transcripts.

The port of `ckb_zkp_tpu/transcript/merlin.py`: the same operations, but
the byte loops and the permutation run in `strobe.c` on the host, built
with the host's C compiler at first use into ``ckb_zkp_tpu_torch/_build/``
and loaded with ctypes (no fallback: a missing compiler or a failed build
raises). `Transcript.append_message` queues its pair, and the queue goes
to C in one call before the next challenge: a Spartan setup at 2^20
constraints absorbs some six million messages (`R1CSInstance.r1cs_to_hash`).
`keccak.py` keeps the pure-Python permutation (SHA3 checks).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from array import array
from itertools import accumulate

STROBE_R = 166

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "strobe.c")
_QUEUE_MAX = 1 << 16  # queued messages that go to C at once
_lib = None


def _build() -> str:
    """The shared library of `strobe.c`, compiled once per source hash."""
    from ..ops.cuda_build import BUILD_DIR

    with open(_SOURCE, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libstrobe_{key}.so")
    if os.path.exists(so):
        return so
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if not cc:
        raise RuntimeError("no C compiler found: the Merlin transcript cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    res = subprocess.run([cc, "-O2", "-std=c99", "-shared", "-fPIC", "-o", tmp, _SOURCE],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cc} failed for strobe.c:\n{res.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded STROBE library (built on first call)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(_build())
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        L.strobe_state_size.restype = i64
        L.strobe_init.argtypes = [p]
        L.strobe_op.argtypes = [p, i64, ctypes.c_int, p, i64]
        L.strobe_op.restype = ctypes.c_int
        L.merlin_append_messages.argtypes = [p, i64, p, p, p, p]
        _lib = L
    return _lib


class Strobe128:
    """The merlin-subset of STROBE-128 (meta_ad / ad / prf / key)."""

    def __init__(self, protocol_label: bytes):
        L = lib()
        self._s = ctypes.create_string_buffer(L.strobe_state_size())
        L.strobe_init(self._s)
        self.meta_ad(protocol_label, False)

    @property
    def state(self) -> bytes:
        return self._s.raw[:200]

    def _op(self, flags: int, more: bool, data, n: int) -> None:
        rc = lib().strobe_op(self._s, flags, int(more), data, n)
        if rc == -1:
            raise AssertionError("flag mismatch on continued op")
        if rc == -2:
            raise AssertionError("transport not supported")

    # --- operations merlin uses ---
    def meta_ad(self, data: bytes, more: bool):
        self._op(FLAG_M | FLAG_A, more, bytes(data), len(data))

    def ad(self, data: bytes, more: bool):
        self._op(FLAG_A, more, bytes(data), len(data))

    def prf(self, n: int, more: bool) -> bytes:
        out = ctypes.create_string_buffer(n)
        self._op(FLAG_I | FLAG_A | FLAG_C, more, out, n)
        return out.raw

    def key(self, data: bytes, more: bool):
        self._op(FLAG_A | FLAG_C, more, bytes(data), len(data))


class Transcript:
    """merlin::Transcript"""

    MERLIN_LABEL = b"Merlin v1.0"

    def __init__(self, label: bytes):
        self._strobe = Strobe128(self.MERLIN_LABEL)
        self._labels: list = []
        self._msgs: list = []
        self.append_message(b"dom-sep", label)

    @property
    def strobe(self) -> Strobe128:
        self._flush()
        return self._strobe

    def _flush(self) -> None:
        labels, msgs = self._labels, self._msgs
        if not labels:
            return
        self._labels, self._msgs = [], []
        loff = array("q", accumulate(map(len, labels), initial=0))
        moff = array("q", accumulate(map(len, msgs), initial=0))
        lib().merlin_append_messages(
            self._strobe._s, len(labels), b"".join(labels),
            (ctypes.c_int64 * len(loff)).from_buffer(loff), b"".join(msgs),
            (ctypes.c_int64 * len(moff)).from_buffer(moff))

    def append_message(self, label: bytes, message: bytes) -> None:
        if len(message) >= 1 << 32:
            raise OverflowError("a Merlin message is at most 2^32 - 1 bytes")
        self._labels.append(bytes(label))
        self._msgs.append(message if type(message) is bytes else bytes(message))
        if len(self._labels) >= _QUEUE_MAX:
            self._flush()

    def append_messages(self, labels: list, messages: list) -> None:
        """`append_message` for each (label, message) pair, in order: the
        pairs queued at once (bytes objects, not copied)."""
        if len(labels) != len(messages):
            raise ValueError("as many labels as messages")
        if any(len(m) >= 1 << 32 for m in messages):
            raise OverflowError("a Merlin message is at most 2^32 - 1 bytes")
        self._labels += labels
        self._msgs += messages
        if len(self._labels) >= _QUEUE_MAX:
            self._flush()

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, int(x).to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        s = self.strobe
        s.meta_ad(label, False)
        s.meta_ad(int(n).to_bytes(4, "little"), True)
        return s.prf(n, False)

# Copied from ckb_zkp_tpu/gadgets/mimc.py (host ints only): the port keeps its own copy.
"""MiMC (LongsightF322p3): native hash + R1CS gadget.

Parity: ckb-zkp gadgets/src/hashes/mimc.rs:13-265 — 322 rounds, two
constraints per round (644 for the block gadget), same byte-chunking into
field limb-width blocks. Round constants derive deterministically from a
zero seed via ChaCha20 (the reference uses Rust's StdRng stream; the
derivation differs byte-for-byte but is fixed for this framework).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..host.field import FieldSpec
from ..r1cs import ONE, ConstraintSystem, Variable
from ..transcript import ChaChaRng

MIMC_ROUNDS = 322
SEED = bytes(32)


@functools.lru_cache(maxsize=None)
def constants(spec: FieldSpec) -> tuple[int, ...]:
    p = spec.modulus
    rng = ChaChaRng(SEED)
    out = []
    while len(out) < MIMC_ROUNDS:
        candidate = int.from_bytes(rng.next_bytes(32), "little")
        if candidate < p:  # rejection sampling, ark from_random_bytes-style
            out.append(candidate)
    return tuple(out)


def mimc_block(spec: FieldSpec, xl: int, xr: int) -> int:
    p = spec.modulus
    cs = constants(spec)
    for i in range(MIMC_ROUNDS):
        t = (xl + cs[i]) % p
        xl, xr = (t * t % p * t + xr) % p, xl
    return xl


def _bytes_to_blocks(spec: FieldSpec, b: bytes) -> list[int]:
    n = spec.nbytes
    out = []
    for i in range(0, len(b), n):
        chunk = b[i : i + n]
        v = int.from_bytes(chunk, "little")
        out.append(v if v < spec.modulus else 0)  # mirrors from_repr fallback
    return out


def mimc_hash(spec: FieldSpec, b: bytes) -> tuple[int, int, int]:
    v = _bytes_to_blocks(spec, b)
    h = 0
    xl = 0
    xr = v[-1]
    for i, blk in enumerate(v):
        if i == len(v) - 1:
            xl = h
        h = mimc_block(spec, h, blk)
    return xl, xr, h


def hash_bytes(spec: FieldSpec, b: bytes) -> int:
    return mimc_hash(spec, b)[2]


def mimc_gadget(cs: ConstraintSystem, spec: FieldSpec, b: bytes | None) -> int | None:
    """Enforce knowledge of a MiMC preimage block pair; returns the image."""
    p = spec.modulus
    consts = constants(spec)
    if b is not None:
        xl_value, xr_value, image_value = mimc_hash(spec, b)
    else:
        xl_value = xr_value = image_value = None
    var_xl = cs.alloc("preimage xl", xl_value)
    var_xr = cs.alloc("preimage xr", xr_value)
    for i in range(MIMC_ROUNDS):
        with cs.ns(f"rounds_{i}"):
            tmp_value = (
                None if xl_value is None else pow((xl_value + consts[i]) % p, 2, p)
            )
            var_tmp = cs.alloc("tmp", tmp_value)
            cs.enforce(
                "tmp = (xL + Ci)^2",
                var_xl + consts[i],
                var_xl + consts[i],
                var_tmp,
            )
            new_xl = (
                None
                if xl_value is None
                else ((xl_value + consts[i]) * tmp_value + xr_value) % p
            )
            var_new_xl = cs.alloc("new_xl", new_xl)
            cs.enforce(
                "new_xL = xR + (xL + Ci)^3",
                var_tmp,
                var_xl + consts[i],
                var_new_xl - var_xr,
            )
            xr_value, var_xr = xl_value, var_xl
            xl_value, var_xl = new_xl, var_new_xl
    return image_value


@dataclass
class AbstractHashMimcOutput:
    value: int | None
    variable: Variable

    @classmethod
    def alloc(cls, cs: ConstraintSystem, value: int | None):
        return cls(value, cs.alloc("mimc_hash", value))

    @classmethod
    def alloc_input(cls, cs: ConstraintSystem, value: int | None):
        return cls(value, cs.alloc_input("mimc_hash", value))

    def get_variables(self):
        return [self.variable]

    def get_variable_values(self):
        return [self.value]


class AbstractHashMimc:
    """AbstractHash impl backing Merkle-tree gadgets (mimc.rs:215-246)."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def hash_enforce(self, cs: ConstraintSystem, params) -> AbstractHashMimcOutput:
        vals = [v for o in params for v in o.get_variable_values()]
        if any(v is None for v in vals):
            data = None  # setup-mode synthesis: shape only
        else:
            data = b"".join(
                int(v).to_bytes(self.spec.nbytes, "little") for v in vals
            )
        r = mimc_gadget(cs, self.spec, data)
        return AbstractHashMimcOutput.alloc(cs, r)

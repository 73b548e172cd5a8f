# Copied from ckb_zkp_tpu/gadgets/poseidon.py (host ints only): the port keeps its own copy.
"""Poseidon hash (https://eprint.iacr.org/2019/458): native + R1CS gadget.

Parity: ckb-zkp gadgets/src/hashes/poseidon.rs:514-863 — sponge with
r=2, c=1 (state width M=3), x^5 S-box, RF=8 full + RP=83 partial rounds, the
same byte-chunking sponge as MiMC, and an AbstractHash adapter.

Deviations (documented): (1) round constants and the MDS matrix are derived
deterministically per-field from ChaCha20 / a Cauchy construction instead of
the reference's hardcoded fp255 tables (which only fit one modulus); (2) the
round schedule is the paper's RF/2–RP–RF/2 split — the reference's loop
(`i < RF/2 || i > RF/2`, poseidon.rs:561) degenerates to a single partial
round, which we treat as a bug, not behavior to match; (3) linear layers
(ark add, MDS mix) are folded into linear combinations instead of allocating
per-step variables, so the gadget is 3 constraints per S-box.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..host.field import FieldSpec
from ..r1cs import ONE, ConstraintSystem, LinearCombination, Variable
from ..transcript import ChaChaRng

R = 2
C = 1
M = R + C
RF = 8
RP = 83
ROUNDS = RF + RP
ALPHA = 5
SEED = b"poseidon-constants-seed-v1______"  # 32 bytes, fixed for the framework


@dataclass(frozen=True)
class PoseidonConstant:
    ark: tuple[tuple[int, ...], ...]  # ROUNDS x M round constants
    mds: tuple[tuple[int, ...], ...]  # M x M MDS matrix


@functools.lru_cache(maxsize=None)
def constants(spec: FieldSpec) -> PoseidonConstant:
    p = spec.modulus
    assert pow(ALPHA, -1, p - 1), "alpha must be invertible mod p-1"
    rng = ChaChaRng(SEED)
    ark: list[tuple[int, ...]] = []
    row: list[int] = []
    while len(ark) < ROUNDS:
        candidate = int.from_bytes(rng.next_bytes(32), "little")
        if candidate < p:
            row.append(candidate)
            if len(row) == M:
                ark.append(tuple(row))
                row = []
    # Cauchy matrix mds[i][j] = 1/(x_i + y_j), x_i = i, y_j = M + j: all
    # sums distinct and nonzero => invertible and MDS over a prime field.
    mds = tuple(
        tuple(pow(i + M + j, -1, p) for j in range(M)) for i in range(M)
    )
    return PoseidonConstant(tuple(ark), mds)


def _is_full_round(i: int) -> bool:
    return i < RF // 2 or i >= RF // 2 + RP


def poseidon_block(spec: FieldSpec, xl: int, xr: int) -> int:
    p = spec.modulus
    rc = constants(spec)
    state = [xl % p, xr % p, 0]
    for i in range(ROUNDS):
        state = [(s + k) % p for s, k in zip(state, rc.ark[i])]
        if _is_full_round(i):
            state = [pow(s, ALPHA, p) for s in state]
        else:
            state[M - 1] = pow(state[M - 1], ALPHA, p)
        state = [
            sum(rc.mds[j][k] * state[k] for k in range(M)) % p for j in range(M)
        ]
    return state[0]


def _bytes_to_blocks(spec: FieldSpec, b: bytes) -> list[int]:
    n = spec.nbytes
    out = []
    for i in range(0, len(b), n):
        v = int.from_bytes(b[i : i + n], "little")
        out.append(v if v < spec.modulus else 0)
    return out


def poseidon_hash(spec: FieldSpec, b: bytes) -> tuple[int, int, int]:
    """Same chaining as the reference (poseidon.rs:588-614): h=0, absorb
    blocks one at a time; returns (xl=h before last block, xr=last block, h)."""
    v = _bytes_to_blocks(spec, b)
    h = 0
    xl = 0
    xr = v[-1]
    for i, blk in enumerate(v):
        if i == len(v) - 1:
            xl = h
        h = poseidon_block(spec, h, blk)
    return xl, xr, h


def hash_bytes(spec: FieldSpec, b: bytes) -> int:
    return poseidon_hash(spec, b)[2]


class _LcState:
    """(LinearCombination, value) pair for one sponge lane."""

    __slots__ = ("lc", "value")

    def __init__(self, lc: LinearCombination, value: int | None):
        self.lc = lc
        self.value = value


def _sbox5(cs: ConstraintSystem, p: int, s: _LcState, tag: str) -> _LcState:
    """x^5 in 3 constraints: x2 = x*x, x4 = x2*x2, x5 = x4*x."""
    x = s.value
    x2 = None if x is None else x * x % p
    x4 = None if x2 is None else x2 * x2 % p
    x5 = None if x4 is None else x4 * x % p
    v2 = cs.alloc(f"{tag}_x2", x2)
    v4 = cs.alloc(f"{tag}_x4", x4)
    v5 = cs.alloc(f"{tag}_x5", x5)
    cs.enforce(f"{tag}_x2 = x*x", s.lc, s.lc, v2)
    cs.enforce(f"{tag}_x4 = x2*x2", v2, v2, v4)
    cs.enforce(f"{tag}_x5 = x4*x", v4, s.lc, v5)
    return _LcState(v5.lc(), x5)


def _mix(p: int, mds, state: list[_LcState]) -> list[_LcState]:
    out = []
    for j in range(M):
        lc = LinearCombination()
        val: int | None = 0
        for k in range(M):
            lc = lc + state[k].lc * mds[j][k]
            if val is not None and state[k].value is not None:
                val = (val + mds[j][k] * state[k].value) % p
            else:
                val = None
        out.append(_LcState(lc, val))
    return out


def poseidon_gadget(
    cs: ConstraintSystem, spec: FieldSpec, b: bytes | None
) -> tuple[int | None, Variable]:
    """Prove knowledge of the last sponge block pair (xl, xr): allocates them
    as witness, runs one permutation in-circuit, binds and returns the image
    (value, variable). Mirrors poseidon.rs:620-772."""
    p = spec.modulus
    rc = constants(spec)
    if b is not None:
        xl, xr, image = poseidon_hash(spec, b)
    else:
        xl = xr = image = None
    var_xl = cs.alloc("preimage xl", xl)
    var_xr = cs.alloc("preimage xr", xr)
    state = [
        _LcState(var_xl.lc(), xl),
        _LcState(var_xr.lc(), xr),
        _LcState(LinearCombination(), 0),
    ]
    for i in range(ROUNDS):
        with cs.ns(f"round_{i}"):
            for j in range(M):
                s = state[j]
                state[j] = _LcState(
                    s.lc + LinearCombination({ONE: rc.ark[i][j]}),
                    None if s.value is None else (s.value + rc.ark[i][j]) % p,
                )
            if _is_full_round(i):
                for j in range(M):
                    state[j] = _sbox5(cs, p, state[j], f"s{j}")
            else:
                state[M - 1] = _sbox5(cs, p, state[M - 1], f"s{M - 1}")
            state = _mix(p, rc.mds, state)
    out = cs.alloc("image", state[0].value)
    cs.enforce("image binding", state[0].lc, LinearCombination({ONE: 1}), out)
    assert state[0].value == image or b is None
    return image, out


@dataclass
class AbstractHashPoseidonOutput:
    value: int | None
    variable: Variable

    @classmethod
    def alloc(cls, cs: ConstraintSystem, value: int | None):
        return cls(value, cs.alloc("poseidon_hash", value))

    @classmethod
    def alloc_input(cls, cs: ConstraintSystem, value: int | None):
        return cls(value, cs.alloc_input("poseidon_hash", value))

    def get_variables(self):
        return [self.variable]

    def get_variable_values(self):
        return [self.value]


class AbstractHashPoseidon:
    """AbstractHash impl (poseidon.rs:814-837)."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def hash_enforce(self, cs: ConstraintSystem, params) -> AbstractHashPoseidonOutput:
        vals = [v for o in params for v in o.get_variable_values()]
        if any(v is None for v in vals):
            data = None  # setup-mode synthesis: shape only
        else:
            data = b"".join(
                int(v).to_bytes(self.spec.nbytes, "little") for v in vals
            )
        r, _var = poseidon_gadget(cs, self.spec, data)
        return AbstractHashPoseidonOutput.alloc(cs, r)

# Copied from ckb_zkp_tpu/gadgets/rescue.py (host ints only): the port keeps its own copy.
"""Rescue hash (https://eprint.iacr.org/2019/426): native + R1CS gadget.

Parity: ckb-zkp gadgets/src/hashes/rescue.rs:20-632 — sponge with
r=2, c=1 (M=3), 22 rounds of alternating x^α / x^(1/α) S-box layers
(α=5), MDS mix + round-key add after each layer, initial key add, same
byte-chunking sponge, AbstractHash adapter.

Deviations: constants/MDS are derived per-field (ChaCha20 / Cauchy) instead
of hardcoded fp255 tables; the inverse S-box is enforced as y^α = x
(3 constraints) instead of the reference's 255-step square-and-multiply
along the INVALPH bits; linear layers fold into linear combinations.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..host.field import FieldSpec
from ..r1cs import ONE, ConstraintSystem, LinearCombination, Variable
from ..transcript import ChaChaRng
from .poseidon import _LcState, _bytes_to_blocks, _mix, _sbox5

R = 2
C = 1
M = R + C
RESCUE_ROUNDS = 22
ALPHA = 5
SEED = b"rescue-constants-seed-v1________"  # 32 bytes, fixed


@dataclass(frozen=True)
class RescueConstant:
    constants: tuple[tuple[int, ...], ...]  # (2*ROUNDS+1) x M round keys
    mds: tuple[tuple[int, ...], ...]
    invalpha: int


@functools.lru_cache(maxsize=None)
def constants(spec: FieldSpec) -> RescueConstant:
    p = spec.modulus
    invalpha = pow(ALPHA, -1, p - 1)
    rng = ChaChaRng(SEED)
    keys: list[tuple[int, ...]] = []
    row: list[int] = []
    while len(keys) < 2 * RESCUE_ROUNDS + 1:
        candidate = int.from_bytes(rng.next_bytes(32), "little")
        if candidate < p:
            row.append(candidate)
            if len(row) == M:
                keys.append(tuple(row))
                row = []
    mds = tuple(
        tuple(pow(i + M + j, -1, p) for j in range(M)) for i in range(M)
    )
    return RescueConstant(tuple(keys), mds, invalpha)


def rescue_block(spec: FieldSpec, xl: int, xr: int) -> int:
    """rescue.rs:337-366: add K0; 2N half-rounds of sbox → MDS → add K_{i+1}."""
    p = spec.modulus
    rc = constants(spec)
    state = [(v + k) % p for v, k in zip([xl % p, xr % p, 0], rc.constants[0])]
    for i in range(2 * RESCUE_ROUNDS):
        exp = ALPHA if i % 2 == 0 else rc.invalpha
        state = [pow(s, exp, p) for s in state]
        state = [
            sum(rc.mds[j][k] * state[k] for k in range(M)) % p for j in range(M)
        ]
        state = [(s + k) % p for s, k in zip(state, rc.constants[i + 1])]
    return state[0]


def rescue_hash(spec: FieldSpec, b: bytes) -> tuple[int, int, int]:
    v = _bytes_to_blocks(spec, b)
    h = 0
    xl = 0
    xr = v[-1]
    for i, blk in enumerate(v):
        if i == len(v) - 1:
            xl = h
        h = rescue_block(spec, h, blk)
    return xl, xr, h


def hash_bytes(spec: FieldSpec, b: bytes) -> int:
    return rescue_hash(spec, b)[2]


def _sbox_inv5(cs: ConstraintSystem, p: int, invalpha: int, s: _LcState, tag: str) -> _LcState:
    """y = x^(1/5) enforced forward: y2 = y*y, y4 = y2*y2, y4*y = x."""
    x = s.value
    y = None if x is None else pow(x, invalpha, p)
    y2 = None if y is None else y * y % p
    y4 = None if y2 is None else y2 * y2 % p
    vy = cs.alloc(f"{tag}_y", y)
    vy2 = cs.alloc(f"{tag}_y2", y2)
    vy4 = cs.alloc(f"{tag}_y4", y4)
    cs.enforce(f"{tag}_y2 = y*y", vy, vy, vy2)
    cs.enforce(f"{tag}_y4 = y2*y2", vy2, vy2, vy4)
    cs.enforce(f"{tag}_x = y4*y", vy4, vy, s.lc)
    return _LcState(vy.lc(), y)


def rescue_gadget(
    cs: ConstraintSystem, spec: FieldSpec, b: bytes | None
) -> tuple[int | None, Variable]:
    """Prove the last sponge block in-circuit (rescue.rs:402-541)."""
    p = spec.modulus
    rc = constants(spec)
    if b is not None:
        xl, xr, image = rescue_hash(spec, b)
    else:
        xl = xr = image = None
    var_xl = cs.alloc("preimage xl", xl)
    var_xr = cs.alloc("preimage xr", xr)
    state = [
        _LcState(var_xl.lc(), xl),
        _LcState(var_xr.lc(), xr),
        _LcState(LinearCombination(), 0),
    ]
    for j in range(M):
        s = state[j]
        state[j] = _LcState(
            s.lc + LinearCombination({ONE: rc.constants[0][j]}),
            None if s.value is None else (s.value + rc.constants[0][j]) % p,
        )
    for i in range(2 * RESCUE_ROUNDS):
        with cs.ns(f"round_{i}"):
            if i % 2 == 0:
                state = [_sbox5(cs, p, state[j], f"s{j}") for j in range(M)]
            else:
                state = [
                    _sbox_inv5(cs, p, rc.invalpha, state[j], f"s{j}")
                    for j in range(M)
                ]
            state = _mix(p, rc.mds, state)
            for j in range(M):
                s = state[j]
                state[j] = _LcState(
                    s.lc + LinearCombination({ONE: rc.constants[i + 1][j]}),
                    None
                    if s.value is None
                    else (s.value + rc.constants[i + 1][j]) % p,
                )
    out = cs.alloc("image", state[0].value)
    cs.enforce("image binding", state[0].lc, LinearCombination({ONE: 1}), out)
    return image, out


@dataclass
class AbstractHashRescueOutput:
    value: int | None
    variable: Variable

    @classmethod
    def alloc(cls, cs: ConstraintSystem, value: int | None):
        return cls(value, cs.alloc("rescue_hash", value))

    @classmethod
    def alloc_input(cls, cs: ConstraintSystem, value: int | None):
        return cls(value, cs.alloc_input("rescue_hash", value))

    def get_variables(self):
        return [self.variable]

    def get_variable_values(self):
        return [self.value]


class AbstractHashRescue:
    """AbstractHash impl (rescue.rs:582-605)."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec

    def hash_enforce(self, cs: ConstraintSystem, params) -> AbstractHashRescueOutput:
        vals = [v for o in params for v in o.get_variable_values()]
        if any(v is None for v in vals):
            data = None  # setup-mode synthesis: shape only
        else:
            data = b"".join(
                int(v).to_bytes(self.spec.nbytes, "little") for v in vals
            )
        r, _var = rescue_gadget(cs, self.spec, data)
        return AbstractHashRescueOutput.alloc(cs, r)

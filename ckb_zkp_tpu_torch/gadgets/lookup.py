# Copied from ckb_zkp_tpu/gadgets/lookup.py (host ints only): the port keeps its own copy.
"""Window table lookup gadgets.

Parity: ckb-zkp gadgets/src/lookup/table.rs:10-331 — 1/2/3-bit
window lookups for 1D (x) and 2D (x,y) constant tables, bits little-endian,
with the inclusion-exclusion coefficient synthesis (`synth`) and the
bits[1]&bits[2] precomputation for the 3-bit case.
"""

from __future__ import annotations

from ..r1cs import ONE, ConstraintSystem, LinearCombination
from .boolean import Boolean
from .fr import AllocatedFr


def synth(window_size: int, constants: list[int], p: int) -> list[int]:
    """Inclusion-exclusion coefficients so that for bit-pattern i the sum of
    coeffs over submasks of i equals constants[i] (table.rs:10-26)."""
    n = 1 << window_size
    assert len(constants) == n
    assignment = [0] * n
    for i, constant in enumerate(constants):
        cur = (constant - assignment[i]) % p
        assignment[i] = cur
        for j in range(i + 1, n):
            if j & i == i:
                assignment[j] = (assignment[j] + cur) % p
    return assignment


def _index(bits: list[Boolean]) -> int | None:
    i = 0
    for k, b in enumerate(bits):
        v = b.get_value()
        if v is None:
            return None
        i |= v << k
    return i


def lookup1_x(cs: ConstraintSystem, b: Boolean, c: list[int]) -> AllocatedFr:
    """1-bit conditional select: r = b ? c[1] : c[0] (table.rs:30-74)."""
    assert len(c) == 2
    if b.is_constant():
        return AllocatedFr.alloc(cs, c[1] if b.constant else c[0])
    true_value = AllocatedFr.alloc(cs, c[1])
    false_value = AllocatedFr.alloc(cs, c[0])
    bv = b.get_value()
    result = AllocatedFr.alloc(cs, None if bv is None else (c[1] if bv else c[0]))
    # cond * (a - b) = r - b
    cs.enforce(
        "conditionally_select",
        b.lc(),
        true_value.variable - false_value.variable,
        result.variable - false_value.variable,
    )
    return result


def lookup2_x(cs: ConstraintSystem, bits: list[Boolean], c: list[int]) -> AllocatedFr:
    """2-bit window 1D lookup in one constraint (table.rs:78-116)."""
    assert len(bits) == 2 and len(c) == 4
    i = _index(bits)
    res = AllocatedFr.alloc(cs, None if i is None else c[i])
    cs.enforce(
        "x-coordinate lookup",
        bits[1].lc(c[3] - c[2] - c[1] + c[0]) + LinearCombination({ONE: c[1] - c[0]}),
        bits[0].lc(),
        res.variable + LinearCombination({ONE: -c[0]}) + bits[1].lc(c[0] - c[2]),
    )
    return res


def lookup2_xy(
    cs: ConstraintSystem, bits: list[Boolean], c: list[tuple[int, int]]
) -> tuple[AllocatedFr, AllocatedFr]:
    """2-bit window 2D lookup, two constraints (table.rs:120-168)."""
    assert len(bits) == 2 and len(c) == 4
    res_x = lookup2_x(cs, bits, [xy[0] for xy in c])
    res_y = lookup2_x(cs, bits, [xy[1] for xy in c])
    return res_x, res_y


def _lookup3_one_coord(
    cs: ConstraintSystem,
    bits: list[Boolean],
    precomp: Boolean,
    coords: list[int],
    p: int,
    value: int | None,
) -> AllocatedFr:
    coeffs = synth(3, coords, p)
    res = AllocatedFr.alloc(cs, value)
    cs.enforce(
        "coordinate lookup",
        LinearCombination({ONE: coeffs[0b001]})
        + bits[1].lc(coeffs[0b011])
        + bits[2].lc(coeffs[0b101])
        + precomp.lc(coeffs[0b111]),
        bits[0].lc(),
        res.variable
        - LinearCombination({ONE: coeffs[0b000]})
        - bits[1].lc(coeffs[0b010])
        - bits[2].lc(coeffs[0b100])
        - precomp.lc(coeffs[0b110]),
    )
    return res


def lookup3_x(
    cs: ConstraintSystem, bits: list[Boolean], coords: list[int], p: int
) -> AllocatedFr:
    """3-bit window 1D lookup: 1 AND + 1 constraint (table.rs:172-237)."""
    assert len(bits) == 3 and len(coords) == 8
    i = _index(bits)
    precomp = Boolean.and_(cs, bits[1], bits[2])
    return _lookup3_one_coord(
        cs, bits, precomp, coords, p, None if i is None else coords[i]
    )


def lookup3_xy(
    cs: ConstraintSystem, bits: list[Boolean], coords: list[tuple[int, int]], p: int
) -> tuple[AllocatedFr, AllocatedFr]:
    """3-bit window 2D lookup: 1 AND + 2 constraints (table.rs:241-331)."""
    assert len(bits) == 3 and len(coords) == 8
    i = _index(bits)
    precomp = Boolean.and_(cs, bits[1], bits[2])
    res_x = _lookup3_one_coord(
        cs, bits, precomp, [xy[0] for xy in coords], p,
        None if i is None else coords[i][0],
    )
    res_y = _lookup3_one_coord(
        cs, bits, precomp, [xy[1] for xy in coords], p,
        None if i is None else coords[i][1],
    )
    return res_x, res_y

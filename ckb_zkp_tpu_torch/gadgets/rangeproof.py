# Copied from ckb_zkp_tpu/gadgets/rangeproof.py (host ints only): the port keeps its own copy.
"""Range comparison gadget via 2^n + B - A bit decomposition.

Parity: ckb-zkp gadgets/src/operator/rangeproof.rs:8-202 —
enforce A > B (or >=) by decomposing 2^n + B - A and constraining the top
bit. `n_bits` bounds the operand magnitude.
"""

from __future__ import annotations

from ..r1cs import ONE, ConstraintSystem, LinearCombination
from .boolean import AllocatedBit


def enforce_greater_than(
    cs: ConstraintSystem,
    p: int,
    a_value: int | None,
    b_value: int | None,
    n_bits: int = 64,
):
    """Allocates a, b and enforces a > b (values < 2^(n_bits-1))."""
    var_a = cs.alloc("range a", a_value)
    var_b = cs.alloc("range b", b_value)
    # w = 2^n + b - a; a > b  <=>  top bit of w is 0
    w_value = (
        None
        if a_value is None or b_value is None
        else ((1 << n_bits) + b_value - a_value) % p
    )
    var_w = cs.alloc("w", w_value)
    cs.enforce(
        "w = 2^n + b - a",
        var_w,
        LinearCombination({ONE: 1}),
        ONE * (1 << n_bits) + var_b - var_a,
    )
    bits = []
    lc = LinearCombination()
    coeff = 1
    for i in range(n_bits + 1):
        bv = None if w_value is None else (w_value >> i) & 1
        bit = AllocatedBit.alloc(cs, bv)
        bits.append(bit)
        lc = lc + bit.variable * coeff
        coeff = coeff * 2 % p
    cs.enforce("w bit decomposition", lc, LinearCombination({ONE: 1}), var_w)
    # a > b  <=>  w < 2^n  <=>  bit n == 0
    cs.enforce(
        "not less than", bits[n_bits].variable, LinearCombination({ONE: 1}), LinearCombination()
    )
    return var_a, var_b

# Copied from ckb_zkp_tpu/gadgets/multieq.py (host ints only): the port keeps its own copy.
"""MultiEq: pack many small bit-width equalities into one field constraint.

Parity: ckb-zkp gadgets/src/operator/multieq.rs:6-123 — accumulates
(lhs, rhs) pairs shifted by 2^bits_used until the field capacity would be
exceeded, then emits a single `lhs * 1 = rhs` constraint. The reference
flushes on Drop; here it's a context manager (`with MultiEq(cs, p) as meq:`)
and flushes on exit.
"""

from __future__ import annotations

from ..r1cs import ONE, ConstraintSystem, LinearCombination


class MultiEq:
    def __init__(self, cs: ConstraintSystem, p: int):
        self.cs = cs
        self.p = p
        self.capacity = p.bit_length() - 1
        self.ops = 0
        self.bits_used = 0
        self.lhs = LinearCombination()
        self.rhs = LinearCombination()

    def _accumulate(self) -> None:
        self.cs.enforce(
            f"multieq {self.ops}",
            self.lhs,
            LinearCombination({ONE: 1}),
            self.rhs,
        )
        self.lhs = LinearCombination()
        self.rhs = LinearCombination()
        self.bits_used = 0
        self.ops += 1

    def enforce_equal(
        self, num_bits: int, lhs: LinearCombination, rhs: LinearCombination
    ) -> None:
        if self.capacity <= self.bits_used + num_bits:
            self._accumulate()
        assert self.capacity > self.bits_used + num_bits
        coeff = 1 << self.bits_used
        self.lhs = self.lhs + lhs * coeff
        self.rhs = self.rhs + rhs * coeff
        self.bits_used += num_bits

    def __enter__(self) -> "MultiEq":
        return self

    def __exit__(self, *exc) -> None:
        if self.bits_used > 0:
            self._accumulate()

# Copied from ckb_zkp_tpu/gadgets/fr.py (host ints only): the port keeps its own copy.
"""AllocatedFr (parity: gadgets/src/algebra/fr.rs:5-100)."""

from __future__ import annotations

from dataclasses import dataclass

from ..r1cs import ONE, ConstraintSystem, LinearCombination, Variable


@dataclass
class AllocatedFr:
    variable: Variable
    value: int | None

    @classmethod
    def alloc(cls, cs: ConstraintSystem, value: int | None) -> "AllocatedFr":
        return cls(cs.alloc("num", value), value)

    def inputize(self, cs: ConstraintSystem) -> None:
        inp = cs.alloc_input("input variable", self.value)
        cs.enforce("enforce input is correct", inp, ONE, self.variable)

    def assert_nonzero(self, cs: ConstraintSystem, p: int) -> None:
        inv = None if self.value is None else pow(self.value, -1, p)
        inv_var = cs.alloc("ephemeral inverse", inv)
        cs.enforce("nonzero assertion", self.variable, inv_var, LinearCombination({ONE: 1}))

    def mul(self, cs: ConstraintSystem, other: "AllocatedFr", p: int) -> "AllocatedFr":
        val = (
            None
            if self.value is None or other.value is None
            else self.value * other.value % p
        )
        out = AllocatedFr.alloc(cs, val)
        cs.enforce("multiplication", self.variable, other.variable, out.variable)
        return out

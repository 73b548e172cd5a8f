# Copied from ckb_zkp_tpu/circuits/mini.py (host ints and numpy only): the port keeps its own copy.
"""The canonical Mini circuit: x * (y + 2) = z, repeated `num` times.

Parity: ckb-zkp cli/src/circuits/mini.rs:6-78 — same allocation
order (aux x, aux y, public z) and constraint shape, so QAP layouts match.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..r1cs import ConstraintSystem


@dataclass
class Mini:
    x: int | None = None
    y: int | None = None
    z: int | None = None
    num: int = 10

    @classmethod
    def power_off(cls) -> "Mini":
        return cls(num=10)

    @classmethod
    def power_on(cls, x: int, y: int, z: int, num: int = 10) -> "Mini":
        return cls(x=x, y=y, z=z, num=num)

    def generate_constraints(self, cs: ConstraintSystem) -> None:
        var_x = cs.alloc("x", self.x)
        var_y = cs.alloc("y", self.y)
        var_z = cs.alloc_input("z(output)", self.z)
        for _ in range(self.num):
            cs.enforce("x * (y + 2) = z", var_x, var_y + 2, var_z)

    @property
    def publics(self) -> list[int]:
        return [self.z]

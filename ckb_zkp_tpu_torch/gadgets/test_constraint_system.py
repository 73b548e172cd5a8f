# Copied from ckb_zkp_tpu/gadgets/test_constraint_system.py (host ints only): the port keeps its own copy.
"""TestConstraintSystem: the mock backend for circuit debugging.

Parity: ckb-zkp gadgets/src/test_constraint_system.rs:20-463 —
records named constraints/assignments, `is_satisfied` /
`which_is_unsatisfied`, `set`/`get` by path, and a keyed-blake2s hash of the
constraint system shape.
"""

from __future__ import annotations

import hashlib

from ..r1cs import ConstraintSystem, SynthesisMode, Variable


class TestConstraintSystem(ConstraintSystem):
    def __init__(self, p: int):
        super().__init__(SynthesisMode.PROVE)
        self.p = p
        self._paths: dict[str, Variable] = {"ONE": Variable("I", 0)}

    # path-tracked allocation
    def alloc(self, name, value=None):
        var = super().alloc(name, value)
        self._paths[self._path(name)] = var
        return var

    def alloc_input(self, name, value=None):
        var = super().alloc_input(name, value)
        self._paths[self._path(name)] = var
        return var

    def set(self, path: str, value: int) -> None:
        var = self._paths[path]
        vals = self.input_values if var.kind == "I" else self.aux_values
        vals[var.index] = value % self.p

    def get(self, path: str) -> int:
        var = self._paths[path]
        vals = self.input_values if var.kind == "I" else self.aux_values
        return int(vals[var.index])

    def is_satisfied(self, p: int | None = None) -> bool:  # type: ignore[override]
        return self.which_is_unsatisfied() is None

    def which_is_unsatisfied(self, p: int | None = None) -> str | None:  # type: ignore[override]
        return super().which_is_unsatisfied(self.p)

    def hash(self) -> bytes:
        """Keyed hash of the constraint-system shape (names + structure)."""
        h = hashlib.blake2s(key=b"ckb_zkp_tpu_tcs")
        h.update(len(self.constraints).to_bytes(8, "little"))
        for name, a, b, c in self.constraints:
            h.update(name.encode())
            for lc in (a, b, c):
                for v, coeff in sorted(
                    lc.terms.items(), key=lambda kv: (kv[0].kind, kv[0].index)
                ):
                    h.update(v.kind.encode())
                    h.update(v.index.to_bytes(8, "little"))
                    h.update((coeff % self.p).to_bytes(64, "little", signed=False))
        return h.digest()

# Copied from ckb_zkp_tpu/gadgets/abstract_hash.py (host ints only): the port keeps its own copy.
"""AbstractHash protocol (parity: gadgets/src/hashes/abstract_hash.rs:6-19)."""

from __future__ import annotations

from typing import Protocol

from ..r1cs import ConstraintSystem, Variable


class AbstractHashOutput(Protocol):
    def get_variables(self) -> list[Variable]: ...
    def get_variable_values(self) -> list[int | None]: ...


class AbstractHash(Protocol):
    @classmethod
    def hash_enforce(
        cls, cs: ConstraintSystem, params: list[AbstractHashOutput]
    ) -> AbstractHashOutput: ...

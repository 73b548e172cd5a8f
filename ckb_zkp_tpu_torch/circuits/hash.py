# Copied from ckb_zkp_tpu/circuits/hash.py (host ints only): the port keeps its own copy.
"""The MiMC-preimage Hash circuit (parity: cli/src/circuits/hash.rs:7-56)."""

from __future__ import annotations

from dataclasses import dataclass

from ..gadgets import mimc
from ..host.field import FieldSpec
from ..r1cs import ConstraintSystem


@dataclass
class Hash:
    spec: FieldSpec
    image: bytes | None = None

    @classmethod
    def power_off(cls, spec: FieldSpec) -> "Hash":
        return cls(spec=spec, image=None)

    @classmethod
    def power_on(cls, spec: FieldSpec, image: bytes) -> "Hash":
        return cls(spec=spec, image=image)

    def generate_constraints(self, cs: ConstraintSystem) -> None:
        with cs.ns("mimc-gadget"):
            value = mimc.mimc_gadget(cs, self.spec, self.image)
        cs.alloc_input("image", value)

    @property
    def publics(self) -> list[int]:
        assert self.image is not None
        return [mimc.hash_bytes(self.spec, self.image)]

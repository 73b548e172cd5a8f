# Copied from ckb_zkp_tpu/r1cs/system.py (host ints and numpy only): the port keeps its own copy.
# R1csShape.witness_limbs and its cache are left out: the port's prover
# converts the witness on every prove, so no limb array can go stale.
"""Constraint system front end producing device-ready flat matrices.

Parity: `ConstraintSystem` trait + `ConstraintSynthesizer`
(ckb-zkp r1cs/src/constraint_system.rs:10-93), `SynthesisError`
(ckb-zkp r1cs/src/error.rs:7-24). Unlike the reference's per-scheme
assemblies, synthesis here always produces one canonical `R1csShape` (COO
matrices + assignments) that every scheme consumes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Protocol

import numpy as np

from .lc import ONE, LinearCombination, Variable


class SynthesisError(Exception):
    """Mirrors the reference's 8-variant error enum; message carries which."""

    ASSIGNMENT_MISSING = "an assignment for a variable could not be computed"
    UNSATISFIABLE = "unsatisfiable constraint system"
    POLYNOMIAL_DEGREE_TOO_LARGE = "polynomial degree is too large"
    UNEXPECTED_IDENTITY = "encountered an identity element"
    MALFORMED_VERIFYING_KEY = "malformed verifying key"


class SynthesisMode(enum.Enum):
    SETUP = "setup"  # values not required (like reference KeypairAssembly)
    PROVE = "prove"  # values required


class ConstraintSynthesizer(Protocol):
    def generate_constraints(self, cs: "ConstraintSystem") -> None: ...


class ConstraintSystem:
    """Collects allocations and A*B=C constraints; namespace-aware."""

    def __init__(self, mode: SynthesisMode = SynthesisMode.PROVE):
        self.mode = mode
        self.input_values: list[int | None] = [1]  # ONE
        self.aux_values: list[int | None] = []
        self.input_names: list[str] = ["ONE"]
        self.aux_names: list[str] = []
        self.constraints: list[tuple[str, LinearCombination, LinearCombination, LinearCombination]] = []
        self._ns: list[str] = []

    # --- namespaces (reference: push_namespace/pop_namespace/ns) ---
    def _path(self, name: str) -> str:
        return "/".join([*self._ns, name])

    class _Namespace:
        def __init__(self, cs, name):
            self.cs, self.name = cs, name

        def __enter__(self):
            self.cs._ns.append(self.name)
            return self.cs

        def __exit__(self, *exc):
            self.cs._ns.pop()

    def ns(self, name: str) -> "ConstraintSystem._Namespace":
        return self._Namespace(self, name)

    # --- allocation ---
    def alloc(self, name: str, value: int | Callable[[], int] | None = None) -> Variable:
        v = self._resolve_value(value)
        self.aux_values.append(v)
        self.aux_names.append(self._path(name))
        return Variable("A", len(self.aux_values) - 1)

    def alloc_input(self, name: str, value: int | Callable[[], int] | None = None) -> Variable:
        v = self._resolve_value(value)
        self.input_values.append(v)
        self.input_names.append(self._path(name))
        return Variable("I", len(self.input_values) - 1)

    def _resolve_value(self, value):
        if callable(value):
            value = value()
        if value is None:
            if self.mode == SynthesisMode.PROVE:
                raise SynthesisError(SynthesisError.ASSIGNMENT_MISSING)
            return None
        return int(value)

    # --- constraints ---
    def enforce(self, name: str, a, b, c) -> None:
        a = LinearCombination._coerce(a)
        b = LinearCombination._coerce(b)
        c = LinearCombination._coerce(c)
        self.constraints.append((self._path(name), a, b, c))

    @property
    def num_inputs(self) -> int:
        return len(self.input_values)

    @property
    def num_aux(self) -> int:
        return len(self.aux_values)

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    # --- finalize ---
    def finalize(self, p: int) -> "R1csShape":
        """Flatten to COO matrices with columns indexed [inputs..., aux...]."""
        ni = self.num_inputs

        def var_col(v: Variable) -> int:
            return v.index if v.kind == "I" else ni + v.index

        mats = []
        for which in range(3):
            rows, cols, coeffs = [], [], []
            for j, cons in enumerate(self.constraints):
                lc = cons[1 + which]
                for v, c in lc.terms.items():
                    c %= p
                    if c:
                        rows.append(j)
                        cols.append(var_col(v))
                        coeffs.append(c)
            mats.append(
                CooMatrix(
                    np.asarray(rows, dtype=np.int32),
                    np.asarray(cols, dtype=np.int32),
                    coeffs,
                )
            )
        inputs = None
        aux = None
        if self.mode == SynthesisMode.PROVE:
            inputs = [int(v) % p for v in self.input_values]
            aux = [int(v) % p for v in self.aux_values]
        return R1csShape(
            num_inputs=ni,
            num_aux=self.num_aux,
            num_constraints=self.num_constraints,
            a=mats[0],
            b=mats[1],
            c=mats[2],
            input_assignment=inputs,
            aux_assignment=aux,
            p=p,
        )

    # --- debugging aid (reference: gadgets TestConstraintSystem) ---
    def is_satisfied(self, p: int) -> bool:
        return self.which_is_unsatisfied(p) is None

    def which_is_unsatisfied(self, p: int) -> str | None:
        def assignment(v: Variable) -> int:
            vals = self.input_values if v.kind == "I" else self.aux_values
            return int(vals[v.index])

        for name, a, b, c in self.constraints:
            if a.evaluate(assignment, p) * b.evaluate(assignment, p) % p != c.evaluate(
                assignment, p
            ):
                return name
        return None


@dataclass
class CooMatrix:
    """COO sparse matrix over Fr; coeffs stay Python ints until device encode."""

    rows: np.ndarray  # int32
    cols: np.ndarray  # int32
    coeffs: list[int]

    @property
    def nnz(self) -> int:
        return len(self.coeffs)


@dataclass
class R1csShape:
    num_inputs: int
    num_aux: int
    num_constraints: int
    a: CooMatrix
    b: CooMatrix
    c: CooMatrix
    p: int
    input_assignment: list[int] | None = None
    aux_assignment: list[int] | None = None

    @property
    def num_variables(self) -> int:
        return self.num_inputs + self.num_aux

    def full_assignment(self) -> list[int]:
        assert self.input_assignment is not None
        return self.input_assignment + self.aux_assignment


def synthesize(
    circuit: ConstraintSynthesizer,
    p: int,
    mode: SynthesisMode = SynthesisMode.PROVE,
) -> R1csShape:
    cs = ConstraintSystem(mode)
    circuit.generate_constraints(cs)
    return cs.finalize(p)

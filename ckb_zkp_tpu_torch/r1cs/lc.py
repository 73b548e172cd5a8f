# Copied from ckb_zkp_tpu/r1cs/lc.py (host ints and numpy only): the port keeps its own copy.
"""Variables and linear combinations.

Mirrors the reference's `Variable`/`Index::{Input, Aux}` and
`LinearCombination` (ckb-zkp r1cs/src/lib.rs:47-71, :187) with python
ergonomics: LCs support +, -, * by scalars and build from variables directly.
Coefficients are Python ints reduced mod the field at synthesis time.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Variable:
    """kind 'I' (public input / instance) or 'A' (aux / witness)."""

    kind: str
    index: int

    def lc(self) -> "LinearCombination":
        return LinearCombination({self: 1})

    def __add__(self, other):
        return self.lc() + other

    def __radd__(self, other):
        return self.lc() + other

    def __sub__(self, other):
        return self.lc() - other

    def __rsub__(self, other):
        return (-self.lc()) + other

    def __mul__(self, coeff: int):
        return self.lc() * coeff

    def __rmul__(self, coeff: int):
        return self.lc() * coeff

    def __neg__(self):
        return -self.lc()


ONE = Variable("I", 0)  # the constant-one input, as in the reference


class LinearCombination:
    """Sparse sum of coeff * variable (plus int constants folded onto ONE)."""

    __slots__ = ("terms",)

    def __init__(self, terms: dict[Variable, int] | None = None):
        self.terms: dict[Variable, int] = dict(terms or {})

    @staticmethod
    def _coerce(x) -> "LinearCombination":
        if isinstance(x, LinearCombination):
            return x
        if isinstance(x, Variable):
            return x.lc()
        if isinstance(x, int):
            return LinearCombination({ONE: x})
        raise TypeError(f"cannot use {type(x)} in a linear combination")

    def __add__(self, other):
        other = self._coerce(other)
        out = dict(self.terms)
        for v, c in other.terms.items():
            out[v] = out.get(v, 0) + c
        return LinearCombination(out)

    __radd__ = __add__

    def __sub__(self, other):
        return self + (-self._coerce(other))

    def __rsub__(self, other):
        return self._coerce(other) + (-self)

    def __neg__(self):
        return LinearCombination({v: -c for v, c in self.terms.items()})

    def __mul__(self, coeff: int):
        assert isinstance(coeff, int)
        return LinearCombination({v: c * coeff for v, c in self.terms.items()})

    __rmul__ = __mul__

    def evaluate(self, assignment, p: int) -> int:
        """assignment: callable Variable -> int value."""
        acc = 0
        for v, c in self.terms.items():
            acc += c * assignment(v)
        return acc % p

# Copied from ckb_zkp_tpu/gadgets/boolean.py (host ints only): the port keeps its own copy.
"""Boolean/bit gadgets.

Parity: ckb-zkp gadgets/src/algebra/boolean.rs:9-1817 —
AllocatedBit with booleanity constraint, xor/and/and_not/nor, Boolean
wrapper (constant or allocated, with negation), sha256 ch/maj single
-constraint helpers, u64/field bit decomposition, enforce_equal.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..r1cs import ONE, ConstraintSystem, LinearCombination, Variable


@dataclass
class AllocatedBit:
    variable: Variable
    value: int | None  # 0/1

    @classmethod
    def alloc(cls, cs: ConstraintSystem, value: int | None) -> "AllocatedBit":
        if value is not None:
            assert value in (0, 1)
        var = cs.alloc("boolean", value)
        # (1 - a) * a = 0
        cs.enforce("boolean constraint", ONE - var, var, LinearCombination())
        return cls(var, value)

    @classmethod
    def xor(cls, cs: ConstraintSystem, a: "AllocatedBit", b: "AllocatedBit"):
        val = None if a.value is None or b.value is None else a.value ^ b.value
        var = cs.alloc("xor result", val)
        # 2a * b = a + b - c
        cs.enforce("xor constraint", a.variable * 2, b.variable, a.variable + b.variable - var)
        return cls(var, val)

    @classmethod
    def and_(cls, cs: ConstraintSystem, a: "AllocatedBit", b: "AllocatedBit"):
        val = None if a.value is None or b.value is None else a.value & b.value
        var = cs.alloc("and result", val)
        cs.enforce("and constraint", a.variable, b.variable, var)
        return cls(var, val)

    @classmethod
    def and_not(cls, cs: ConstraintSystem, a: "AllocatedBit", b: "AllocatedBit"):
        val = None if a.value is None or b.value is None else a.value & (1 - b.value)
        var = cs.alloc("and not result", val)
        cs.enforce("and not constraint", a.variable, ONE - b.variable, var)
        return cls(var, val)

    @classmethod
    def nor(cls, cs: ConstraintSystem, a: "AllocatedBit", b: "AllocatedBit"):
        val = None if a.value is None or b.value is None else (1 - a.value) & (1 - b.value)
        var = cs.alloc("nor result", val)
        cs.enforce("nor constraint", ONE - a.variable, ONE - b.variable, var)
        return cls(var, val)


@dataclass
class Boolean:
    """Constant true/false, an allocated bit, or its negation."""

    bit: AllocatedBit | None = None
    negated: bool = False
    constant: bool | None = None

    @classmethod
    def true(cls):
        return cls(constant=True)

    @classmethod
    def false(cls):
        return cls(constant=False)

    @classmethod
    def from_bit(cls, bit: AllocatedBit):
        return cls(bit=bit)

    def get_value(self) -> int | None:
        if self.constant is not None:
            return int(self.constant)
        if self.bit is None or self.bit.value is None:
            return None
        return self.bit.value ^ int(self.negated)

    def not_(self) -> "Boolean":
        if self.constant is not None:
            return Boolean(constant=not self.constant)
        return Boolean(bit=self.bit, negated=not self.negated)

    def lc(self, coeff: int = 1) -> LinearCombination:
        if self.constant is not None:
            return LinearCombination({ONE: coeff}) if self.constant else LinearCombination()
        base = self.bit.variable * coeff
        if self.negated:
            return ONE * coeff - base
        return LinearCombination._coerce(base)

    @staticmethod
    def xor(cs: ConstraintSystem, a: "Boolean", b: "Boolean") -> "Boolean":
        if a.constant is not None:
            return b if not a.constant else b.not_()
        if b.constant is not None:
            return a if not b.constant else a.not_()
        if a.negated == b.negated:
            return Boolean.from_bit(AllocatedBit.xor(cs, a.bit, b.bit))
        return Boolean(bit=AllocatedBit.xor(cs, a.bit, b.bit), negated=True)

    def is_constant(self) -> bool:
        return self.constant is not None

    @staticmethod
    def enforce_equal(cs: ConstraintSystem, a: "Boolean", b: "Boolean") -> None:
        """boolean.rs enforce_equal: a == b as one constraint (or a check)."""
        if a.constant is not None and b.constant is not None:
            if a.constant != b.constant:
                raise ValueError("unsatisfiable: unequal boolean constants")
            return
        cs.enforce("enforce equal", LinearCombination(), LinearCombination(), a.lc() - b.lc())

    @staticmethod
    def and_(cs: ConstraintSystem, a: "Boolean", b: "Boolean") -> "Boolean":
        if a.constant is not None:
            return b if a.constant else Boolean.false()
        if b.constant is not None:
            return a if b.constant else Boolean.false()
        if not a.negated and not b.negated:
            return Boolean.from_bit(AllocatedBit.and_(cs, a.bit, b.bit))
        if not a.negated and b.negated:
            return Boolean.from_bit(AllocatedBit.and_not(cs, a.bit, b.bit))
        if a.negated and not b.negated:
            return Boolean.from_bit(AllocatedBit.and_not(cs, b.bit, a.bit))
        return Boolean.from_bit(AllocatedBit.nor(cs, a.bit, b.bit))


def _value3(a: Boolean, b: Boolean, c: Boolean):
    va, vb, vc = a.get_value(), b.get_value(), c.get_value()
    if va is None or vb is None or vc is None:
        return None, None, None, False
    return va, vb, vc, True


def sha256_ch(cs: ConstraintSystem, a: Boolean, b: Boolean, c: Boolean) -> Boolean:
    """(a and b) xor ((not a) and c) in ONE constraint (boolean.rs:463-567).

    Generic case: alloc ch; enforce (b - c) * a = ch - c.
    """
    va, vb, vc, known = _value3(a, b, c)
    ch_value = ((va & vb) ^ ((1 - va) & vc)) if known else None
    if a.is_constant() and b.is_constant() and c.is_constant():
        return Boolean.true() if ch_value else Boolean.false()
    if a.constant is False:
        return c
    if b.constant is False:
        return Boolean.and_(cs, a.not_(), c)
    if c.constant is False:
        return Boolean.and_(cs, a, b)
    if c.constant is True:
        return Boolean.and_(cs, a, b.not_()).not_()
    if b.constant is True:
        return Boolean.and_(cs, a.not_(), c.not_()).not_()
    # a is Constant(true) falls through in the reference too: ch = b xor ((not a) and c) = b... the
    # reference keeps the generic constraint, which stays sound since a.lc() is then the constant 1.
    var = cs.alloc("ch", ch_value)
    cs.enforce("ch computation", b.lc() - c.lc(), a.lc(), var - c.lc())
    return Boolean.from_bit(AllocatedBit(var, ch_value))


def sha256_maj(cs: ConstraintSystem, a: Boolean, b: Boolean, c: Boolean) -> Boolean:
    """(a and b) xor (a and c) xor (b and c) in TWO constraints
    (boolean.rs:570-684): bc = b*c; (2bc - b - c) * a = bc - maj."""
    va, vb, vc, known = _value3(a, b, c)
    maj_value = ((va & vb) ^ (va & vc) ^ (vb & vc)) if known else None
    if a.is_constant() and b.is_constant() and c.is_constant():
        return Boolean.true() if maj_value else Boolean.false()
    if a.constant is False:
        return Boolean.and_(cs, b, c)
    if b.constant is False:
        return Boolean.and_(cs, a, c)
    if c.constant is False:
        return Boolean.and_(cs, a, b)
    if c.constant is True:
        return Boolean.and_(cs, a.not_(), b.not_()).not_()
    if b.constant is True:
        return Boolean.and_(cs, a.not_(), c.not_()).not_()
    if a.constant is True:
        return Boolean.and_(cs, b.not_(), c.not_()).not_()
    var = cs.alloc("maj", maj_value)
    bc = Boolean.and_(cs, b, c)
    cs.enforce(
        "maj computation",
        bc.lc() + bc.lc() - b.lc() - c.lc(),
        a.lc(),
        bc.lc() - var,
    )
    return Boolean.from_bit(AllocatedBit(var, maj_value))


def u64_into_boolean_vec_le(
    cs: ConstraintSystem, value: int | None
) -> list[Boolean]:
    """boolean.rs:693+ — 64 allocated LE bits of a u64."""
    out = []
    for i in range(64):
        bv = None if value is None else (value >> i) & 1
        out.append(Boolean.from_bit(AllocatedBit.alloc(cs, bv)))
    return out


def field_into_allocated_bits_le(
    cs: ConstraintSystem, p: int, value: int | None
) -> list[AllocatedBit]:
    """Bit-decompose a field element (LE) with a packing constraint."""
    nbits = p.bit_length()
    bits = []
    for i in range(nbits):
        bv = None if value is None else (value >> i) & 1
        bits.append(AllocatedBit.alloc(cs, bv))
    # sum 2^i b_i * 1 = value
    var_val = cs.alloc("packed value", value)
    lc = LinearCombination()
    coeff = 1
    for b in bits:
        lc = lc + b.variable * coeff
        coeff = (coeff * 2) % p
    cs.enforce("bit packing", lc, LinearCombination({ONE: 1}), var_val)
    return bits

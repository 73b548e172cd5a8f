# Copied from ckb_zkp_tpu/gadgets/uint32.py (host ints only): the port keeps its own copy.
"""UInt32: 32 Booleans (LSB first) interpreted as an unsigned integer.

Parity: ckb-zkp gadgets/src/algebra/uint32.rs:12-369 — constant /
alloc constructors, BE/LE bit conversions, rotr/shr (free), xor, sha256
ch/maj tri-ops, and `addmany` modular addition of 2..=10 operands packed
through a MultiEq accumulator.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..r1cs import ConstraintSystem, LinearCombination
from .boolean import AllocatedBit, Boolean, sha256_ch, sha256_maj
from .multieq import MultiEq

MASK32 = 0xFFFFFFFF


@dataclass
class UInt32:
    bits: list[Boolean]  # least significant bit first
    value: int | None

    @classmethod
    def constant(cls, value: int) -> "UInt32":
        value &= MASK32
        bits = [Boolean(constant=bool((value >> i) & 1)) for i in range(32)]
        return cls(bits, value)

    @classmethod
    def alloc(cls, cs: ConstraintSystem, value: int | None) -> "UInt32":
        bits = []
        for i in range(32):
            bv = None if value is None else (value >> i) & 1
            bits.append(Boolean.from_bit(AllocatedBit.alloc(cs, bv)))
        return cls(bits, None if value is None else value & MASK32)

    # --- bit-order conversions (uint32.rs:66-137) ---
    def into_bits_be(self) -> list[Boolean]:
        return list(reversed(self.bits))

    @classmethod
    def from_bits_be(cls, bits: list[Boolean]) -> "UInt32":
        assert len(bits) == 32
        return cls._from_le(list(reversed(bits)))

    def into_bits(self) -> list[Boolean]:
        return list(self.bits)

    @classmethod
    def from_bits(cls, bits: list[Boolean]) -> "UInt32":
        assert len(bits) == 32
        return cls._from_le(list(bits))

    @classmethod
    def _from_le(cls, bits_le: list[Boolean]) -> "UInt32":
        value = 0
        for i, b in enumerate(bits_le):
            v = b.get_value()
            if v is None:
                value = None
                break
            value |= v << i
        return cls(bits_le, value)

    # --- free shifts/rotations (uint32.rs:139-175) ---
    def rotr(self, by: int) -> "UInt32":
        by %= 32
        new_bits = [self.bits[(i + by) % 32] for i in range(32)]
        val = None
        if self.value is not None:
            val = ((self.value >> by) | (self.value << (32 - by))) & MASK32
        return UInt32(new_bits, val)

    def shr(self, by: int) -> "UInt32":
        by %= 32
        fill = Boolean.false()
        new_bits = self.bits[by:] + [fill] * by
        val = None if self.value is None else (self.value >> by)
        return UInt32(new_bits, val)

    # --- bitwise ops ---
    def xor(self, cs: ConstraintSystem, other: "UInt32") -> "UInt32":
        val = None
        if self.value is not None and other.value is not None:
            val = self.value ^ other.value
        bits = [Boolean.xor(cs, a, b) for a, b in zip(self.bits, other.bits)]
        return UInt32(bits, val)

    @classmethod
    def sha256_maj(cls, cs, a: "UInt32", b: "UInt32", c: "UInt32") -> "UInt32":
        return cls._triop(cs, a, b, c, lambda x, y, z: (x & y) ^ (x & z) ^ (y & z), sha256_maj)

    @classmethod
    def sha256_ch(cls, cs, a: "UInt32", b: "UInt32", c: "UInt32") -> "UInt32":
        return cls._triop(cs, a, b, c, lambda x, y, z: (x & y) ^ (~x & z & MASK32), sha256_ch)

    @classmethod
    def _triop(cls, cs, a, b, c, tri_fn, circuit_fn) -> "UInt32":
        val = None
        if a.value is not None and b.value is not None and c.value is not None:
            val = tri_fn(a.value, b.value, c.value) & MASK32
        bits = [
            circuit_fn(cs, x, y, z) for x, y, z in zip(a.bits, b.bits, c.bits)
        ]
        return cls(bits, val)

    # --- modular multi-addition (uint32.rs:271-369) ---
    @classmethod
    def addmany(cls, meq: MultiEq, operands: list["UInt32"]) -> "UInt32":
        assert 2 <= len(operands) <= 10
        cs = meq.cs
        max_value = len(operands) * MASK32
        result_value: int | None = 0
        lc = LinearCombination()
        all_constants = True
        for op in operands:
            if op.value is None:
                result_value = None
            elif result_value is not None:
                result_value += op.value
            coeff = 1
            for bit in op.bits:
                lc = lc + bit.lc(coeff)
                all_constants &= bit.is_constant()
                coeff <<= 1
        modular_value = None if result_value is None else result_value & MASK32
        if all_constants and modular_value is not None:
            return cls.constant(modular_value)

        result_bits: list[Boolean] = []
        result_lc = LinearCombination()
        coeff = 1
        i = 0
        while max_value != 0:
            bv = None if result_value is None else (result_value >> i) & 1
            b = AllocatedBit.alloc(cs, bv)
            result_lc = result_lc + b.variable * coeff
            result_bits.append(Boolean.from_bit(b))
            max_value >>= 1
            i += 1
            coeff <<= 1
        meq.enforce_equal(i, lc, result_lc)
        return cls(result_bits[:32], modular_value)

# Copied from ckb_zkp_tpu/gadgets/sha256.py (host ints only): the port keeps its own copy.
"""SHA-256 gadget (RFC 6234) over the R1CS front-end.

Parity: ckb-zkp gadgets/src/hashes/sha256.rs:33-481 —
`sha256_block_no_padding` (one compression from IV), `sha256` (full padding
+ multi-block), the compression function with deferred a/e additions folded
into MultiEq-packed addmany constraints, and the AbstractHash adapter.
Native check: hashlib.sha256.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..r1cs import ConstraintSystem, Variable
from .abstract_hash import AbstractHashOutput
from .boolean import AllocatedBit, Boolean
from .multieq import MultiEq
from .uint32 import UInt32

ROUND_CONSTANTS = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


def get_sha256_iv() -> list[UInt32]:
    return [UInt32.constant(v) for v in IV]


def sha256_block_no_padding(
    cs: ConstraintSystem, p: int, input_bits: list[Boolean]
) -> list[Boolean]:
    assert len(input_bits) == 512
    out = sha256_compression_function(cs, p, input_bits, get_sha256_iv())
    return [b for word in out for b in word.into_bits_be()]


def sha256(cs: ConstraintSystem, p: int, input_bits: list[Boolean]) -> list[Boolean]:
    assert len(input_bits) % 8 == 0
    padded = list(input_bits)
    plen = len(padded)
    padded.append(Boolean.true())
    while (len(padded) + 64) % 512 != 0:
        padded.append(Boolean.false())
    for i in reversed(range(64)):
        padded.append(Boolean(constant=bool((plen >> i) & 1)))
    assert len(padded) % 512 == 0

    cur = get_sha256_iv()
    for i in range(0, len(padded), 512):
        with cs.ns(f"block_{i // 512}"):
            cur = sha256_compression_function(cs, p, padded[i : i + 512], cur)
    return [b for word in cur for b in word.into_bits_be()]


class _Maybe:
    """Deferred addmany operand list (sha256.rs:130-149): postpones the a/e
    state additions one round so each lands in a single packed constraint."""

    def __init__(self, concrete: UInt32 | None = None, deferred: list[UInt32] | None = None):
        self.concrete = concrete
        self.deferred = deferred

    def compute(self, meq: MultiEq, others: list[UInt32]) -> UInt32:
        if self.concrete is not None:
            return self.concrete
        return UInt32.addmany(meq, self.deferred + others)


def sha256_compression_function(
    cs: ConstraintSystem, p: int, input_bits: list[Boolean], current: list[UInt32]
) -> list[UInt32]:
    assert len(input_bits) == 512
    assert len(current) == 8

    w = [UInt32.from_bits_be(input_bits[i : i + 32]) for i in range(0, 512, 32)]

    with MultiEq(cs, p) as meq:
        for i in range(16, 64):
            with cs.ns(f"w_extension_{i}"):
                s0 = w[i - 15].rotr(7).xor(cs, w[i - 15].rotr(18)).xor(cs, w[i - 15].shr(3))
                s1 = w[i - 2].rotr(17).xor(cs, w[i - 2].rotr(19)).xor(cs, w[i - 2].shr(10))
                w.append(UInt32.addmany(meq, [w[i - 16], s0, w[i - 7], s1]))

        a = _Maybe(concrete=current[0])
        b = current[1]
        c = current[2]
        d = current[3]
        e = _Maybe(concrete=current[4])
        f = current[5]
        g = current[6]
        h = current[7]

        for i in range(64):
            with cs.ns(f"compression_round_{i}"):
                new_e = e.compute(meq, [])
                s1 = new_e.rotr(6).xor(cs, new_e.rotr(11)).xor(cs, new_e.rotr(25))
                ch = UInt32.sha256_ch(cs, new_e, f, g)
                temp1 = [h, s1, ch, UInt32.constant(ROUND_CONSTANTS[i]), w[i]]
                new_a = a.compute(meq, [])
                s0 = new_a.rotr(2).xor(cs, new_a.rotr(13)).xor(cs, new_a.rotr(22))
                maj = UInt32.sha256_maj(cs, new_a, b, c)
                temp2 = [s0, maj]

                h = g
                g = f
                f = new_e
                e = _Maybe(deferred=temp1 + [d])
                d = c
                c = b
                b = new_a
                a = _Maybe(deferred=temp1 + temp2)

        h0 = a.compute(meq, [current[0]])
        h1 = UInt32.addmany(meq, [current[1], b])
        h2 = UInt32.addmany(meq, [current[2], c])
        h3 = UInt32.addmany(meq, [current[3], d])
        h4 = e.compute(meq, [current[4]])
        h5 = UInt32.addmany(meq, [current[5], f])
        h6 = UInt32.addmany(meq, [current[6], g])
        h7 = UInt32.addmany(meq, [current[7], h])

    return [h0, h1, h2, h3, h4, h5, h6, h7]


def bits_to_bytes_be(bits: list[Boolean]) -> bytes:
    """MSB-first Boolean list → bytes (for checking against hashlib)."""
    assert len(bits) % 8 == 0
    out = bytearray()
    for i in range(0, len(bits), 8):
        byte = 0
        for b in bits[i : i + 8]:
            v = b.get_value()
            assert v is not None
            byte = (byte << 1) | v
        out.append(byte)
    return bytes(out)


def bytes_to_bits_be(data: bytes) -> list[bool]:
    return [bool((byte >> i) & 1) for byte in data for i in reversed(range(8))]


def sha256_native(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


@dataclass
class AbstractHashSha256Output(AbstractHashOutput):
    """sha256.rs:259-330 — 256 allocated bits of a digest."""

    values: list[int | None]
    variables: list[Variable]

    @classmethod
    def alloc(cls, cs: ConstraintSystem, digest: bytes) -> "AbstractHashSha256Output":
        return cls._alloc(cs, digest, cs.alloc)

    @classmethod
    def alloc_input(cls, cs: ConstraintSystem, digest: bytes) -> "AbstractHashSha256Output":
        return cls._alloc(cs, digest, cs.alloc_input)

    @classmethod
    def _alloc(cls, cs, digest, alloc_fn):
        # digest=None: setup-mode allocation (values unassigned), matching
        # the reference's Option<Vec<u8>> circuits (merkle_tree_sha256.rs)
        bits = [None] * 256 if digest is None else bytes_to_bits_be(digest)
        values, variables = [], []
        for bit in bits:
            v = None if bit is None else int(bit)
            var = alloc_fn("output_bit", v)
            values.append(v)
            variables.append(var)
        return cls(values, variables)

    def get_variables(self):
        return self.variables

    def get_variable_values(self):
        return self.values


class AbstractHashSha256:
    """AbstractHash impl: hash the concatenated input bits in-circuit and
    constrain the result bits equal to the allocated output."""

    def __init__(self, p: int):
        self.p = p

    def hash_enforce(self, cs: ConstraintSystem, params) -> AbstractHashSha256Output:
        in_bits: list[Boolean] = []
        for o in params:
            for var, val in zip(o.get_variables(), o.get_variable_values()):
                in_bits.append(Boolean.from_bit(AllocatedBit(var, val)))
        out_bits = sha256(cs, self.p, in_bits)
        values, variables = [], []
        for i, ob in enumerate(out_bits):
            bv = ob.get_value()
            var = cs.alloc(f"sha256_out_{i}", bv)
            cs.enforce(
                f"sha256_out_eq_{i}",
                ob.lc(),
                Boolean.true().lc(),
                var.lc(),
            )
            values.append(bv)
            variables.append(var)
        return AbstractHashSha256Output(values, variables)

# Copied from ckb_zkp_tpu/gadgets/blake2s.py (host ints only): the port keeps its own copy.
"""BLAKE2s gadget (RFC 7693) with 8-byte personalization support.

Parity: ckb-zkp gadgets/src/hashes/blake2s.rs:166-679 — compression
with the 10-round SIGMA schedule and MultiEq-packed G mixing, `blake2s`
padding/IV/personalization exactly as the reference (digest_size=32, keyless).
Native check: hashlib.blake2s(person=...).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..r1cs import ConstraintSystem, Variable
from .abstract_hash import AbstractHashOutput
from .boolean import AllocatedBit, Boolean
from .multieq import MultiEq
from .uint32 import UInt32

R1, R2, R3, R4 = 16, 12, 8, 7

SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

BLAKE2S_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


def _mixing_g(cs, meq: MultiEq, v: list[UInt32], a, b, c, d, x: UInt32, y: UInt32):
    """blake2s.rs:100-133 — the G mixing primitive."""
    v[a] = UInt32.addmany(meq, [v[a], v[b], x])
    v[d] = v[d].xor(cs, v[a]).rotr(R1)
    v[c] = UInt32.addmany(meq, [v[c], v[d]])
    v[b] = v[b].xor(cs, v[c]).rotr(R2)
    v[a] = UInt32.addmany(meq, [v[a], v[b], y])
    v[d] = v[d].xor(cs, v[a]).rotr(R3)
    v[c] = UInt32.addmany(meq, [v[c], v[d]])
    v[b] = v[b].xor(cs, v[c]).rotr(R4)


def blake2s_compression(
    cs: ConstraintSystem, p: int, h: list[UInt32], m: list[UInt32], t: int, f: bool
) -> None:
    assert len(h) == 8 and len(m) == 16
    v = list(h) + [UInt32.constant(iv) for iv in BLAKE2S_IV]
    v[12] = v[12].xor(cs, UInt32.constant(t & 0xFFFFFFFF))
    v[13] = v[13].xor(cs, UInt32.constant((t >> 32) & 0xFFFFFFFF))
    if f:
        v[14] = v[14].xor(cs, UInt32.constant(0xFFFFFFFF))

    with MultiEq(cs, p) as meq:
        for i in range(10):
            with cs.ns(f"round_{i}"):
                s = SIGMA[i % 10]
                _mixing_g(cs, meq, v, 0, 4, 8, 12, m[s[0]], m[s[1]])
                _mixing_g(cs, meq, v, 1, 5, 9, 13, m[s[2]], m[s[3]])
                _mixing_g(cs, meq, v, 2, 6, 10, 14, m[s[4]], m[s[5]])
                _mixing_g(cs, meq, v, 3, 7, 11, 15, m[s[6]], m[s[7]])
                _mixing_g(cs, meq, v, 0, 5, 10, 15, m[s[8]], m[s[9]])
                _mixing_g(cs, meq, v, 1, 6, 11, 12, m[s[10]], m[s[11]])
                _mixing_g(cs, meq, v, 2, 7, 8, 13, m[s[12]], m[s[13]])
                _mixing_g(cs, meq, v, 3, 4, 9, 14, m[s[14]], m[s[15]])

    for i in range(8):
        h[i] = h[i].xor(cs, v[i]).xor(cs, v[i + 8])


def blake2s(
    cs: ConstraintSystem, p: int, input_bits: list[Boolean], personalization: bytes
) -> list[Boolean]:
    assert len(personalization) == 8
    assert len(input_bits) % 8 == 0

    h = [
        UInt32.constant(BLAKE2S_IV[0] ^ 0x01010000 ^ 32),
        UInt32.constant(BLAKE2S_IV[1]),
        UInt32.constant(BLAKE2S_IV[2]),
        UInt32.constant(BLAKE2S_IV[3]),
        UInt32.constant(BLAKE2S_IV[4]),
        UInt32.constant(BLAKE2S_IV[5]),
        UInt32.constant(BLAKE2S_IV[6] ^ int.from_bytes(personalization[0:4], "little")),
        UInt32.constant(BLAKE2S_IV[7] ^ int.from_bytes(personalization[4:8], "little")),
    ]

    blocks: list[list[UInt32]] = []
    for i in range(0, len(input_bits), 512):
        block = input_bits[i : i + 512]
        this_block = []
        for j in range(0, len(block), 32):
            word = block[j : j + 32]
            word = word + [Boolean.false()] * (32 - len(word))
            this_block.append(UInt32.from_bits(word))
        while len(this_block) < 16:
            this_block.append(UInt32.constant(0))
        blocks.append(this_block)
    if not blocks:
        blocks.append([UInt32.constant(0) for _ in range(16)])

    for i, block in enumerate(blocks[:-1]):
        with cs.ns(f"block_{i}"):
            blake2s_compression(cs, p, h, block, (i + 1) * 64, False)
    with cs.ns("final_block"):
        blake2s_compression(cs, p, h, blocks[-1], len(input_bits) // 8, True)

    return [b for word in h for b in word.into_bits()]


def bits_to_bytes_le(bits: list[Boolean]) -> bytes:
    """LSB-first-within-byte Boolean list → bytes (blake2s output order)."""
    assert len(bits) % 8 == 0
    out = bytearray()
    for i in range(0, len(bits), 8):
        byte = 0
        for k, b in enumerate(bits[i : i + 8]):
            v = b.get_value()
            assert v is not None
            byte |= v << k
        out.append(byte)
    return bytes(out)


def bytes_to_bits_le(data: bytes) -> list[bool]:
    return [bool((byte >> i) & 1) for byte in data for i in range(8)]


def blake2s_native(data: bytes, personalization: bytes = bytes(8)) -> bytes:
    return hashlib.blake2s(data, digest_size=32, person=personalization).digest()


@dataclass
class AbstractHashBlake2sOutput(AbstractHashOutput):
    """blake2s.rs AbstractHash adapter — 256 allocated LE bits of a digest."""

    values: list[int | None]
    variables: list[Variable]

    @classmethod
    def alloc(cls, cs: ConstraintSystem, digest: bytes) -> "AbstractHashBlake2sOutput":
        return cls._alloc(cs, digest, cs.alloc)

    @classmethod
    def alloc_input(cls, cs: ConstraintSystem, digest: bytes) -> "AbstractHashBlake2sOutput":
        return cls._alloc(cs, digest, cs.alloc_input)

    @classmethod
    def _alloc(cls, cs, digest, alloc_fn):
        values, variables = [], []
        for bit in bytes_to_bits_le(digest):
            v = int(bit)
            variables.append(alloc_fn("output_bit", v))
            values.append(v)
        return cls(values, variables)

    def get_variables(self):
        return self.variables

    def get_variable_values(self):
        return self.values


class AbstractHashBlake2s:
    def __init__(self, p: int, personalization: bytes = bytes(8)):
        self.p = p
        self.personalization = personalization

    def hash_enforce(self, cs: ConstraintSystem, params) -> AbstractHashBlake2sOutput:
        in_bits: list[Boolean] = []
        for o in params:
            for var, val in zip(o.get_variables(), o.get_variable_values()):
                in_bits.append(Boolean.from_bit(AllocatedBit(var, val)))
        out_bits = blake2s(cs, self.p, in_bits, self.personalization)
        values, variables = [], []
        for i, ob in enumerate(out_bits):
            bv = ob.get_value()
            var = cs.alloc(f"blake2s_out_{i}", bv)
            cs.enforce(f"blake2s_out_eq_{i}", ob.lc(), Boolean.true().lc(), var.lc())
            values.append(bv)
            variables.append(var)
        return AbstractHashBlake2sOutput(values, variables)

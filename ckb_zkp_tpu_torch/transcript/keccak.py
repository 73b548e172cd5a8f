# Copied from ckb_zkp_tpu/transcript/keccak.py (host ints only): the port keeps its own copy.
"""Keccak-f[1600] permutation (pure Python, host side).

Transcripts are tiny and strictly sequential, so they live on the host —
same placement as the reference, where merlin runs on CPU regardless
(SURVEY.md §2.1 merlin row). Validated against hashlib's SHA3 (see tests).
"""

from __future__ import annotations

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK


def keccak_f1600(state: bytearray) -> None:
    """In-place permutation of a 200-byte state (little-endian lanes)."""
    lanes = [
        int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)
    ]
    # lane (x, y) at index x + 5*y
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [
            lanes[x] ^ lanes[x + 5] ^ lanes[x + 10] ^ lanes[x + 15] ^ lanes[x + 20]
            for x in range(5)
        ]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                lanes[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(
                    lanes[x + 5 * y], _ROTATIONS[x][y]
                )
        # chi
        for x in range(5):
            for y in range(5):
                lanes[x + 5 * y] = b[x + 5 * y] ^ (
                    (~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y] & _MASK
                )
        # iota
        lanes[0] ^= rc
    for i in range(25):
        state[8 * i : 8 * i + 8] = lanes[i].to_bytes(8, "little")


def sha3_256(data: bytes) -> bytes:
    """SHA3-256 built on keccak_f1600 (used to validate the permutation)."""
    rate = 136
    state = bytearray(200)
    padded = bytearray(data)
    padded.append(0x06)
    while len(padded) % rate != 0:
        padded.append(0)
    padded[-1] |= 0x80
    for off in range(0, len(padded), rate):
        for i in range(rate):
            state[i] ^= padded[off + i]
        keccak_f1600(state)
    return bytes(state[:32])

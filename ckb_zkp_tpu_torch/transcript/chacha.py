# Copied from ckb_zkp_tpu/transcript/chacha.py (host ints only): the port keeps its own copy.
"""ChaCha20 keystream RNG (RFC 8439 block function).

Backs the marlin/plonk FiatShamirRng (reference:
ckb-zkp marlin/src/fs_rng.rs:11-70 uses rand_chacha::ChaChaRng seeded
from a digest chain). Host side; validated against the RFC test vector.
"""

from __future__ import annotations

import struct

_MASK = 0xFFFFFFFF


def _rotl32(x, n):
    return ((x << n) | (x >> (32 - n))) & _MASK


def _quarter(state, a, b, c, d):
    state[a] = (state[a] + state[b]) & _MASK
    state[d] = _rotl32(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotl32(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b]) & _MASK
    state[d] = _rotl32(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK
    state[b] = _rotl32(state[b] ^ state[c], 7)


def chacha20_block(key: bytes, counter: int, nonce: bytes) -> bytes:
    assert len(key) == 32 and len(nonce) == 12
    consts = struct.unpack("<4I", b"expand 32-byte k")
    state = list(consts) + list(struct.unpack("<8I", key)) + [counter & _MASK] + list(
        struct.unpack("<3I", nonce)
    )
    working = list(state)
    for _ in range(10):
        _quarter(working, 0, 4, 8, 12)
        _quarter(working, 1, 5, 9, 13)
        _quarter(working, 2, 6, 10, 14)
        _quarter(working, 3, 7, 11, 15)
        _quarter(working, 0, 5, 10, 15)
        _quarter(working, 1, 6, 11, 12)
        _quarter(working, 2, 7, 8, 13)
        _quarter(working, 3, 4, 9, 14)
    out = [(w + s) & _MASK for w, s in zip(working, state)]
    return struct.pack("<16I", *out)


class ChaChaRng:
    """rand_chacha::ChaCha20Rng-compatible stream (seed = 32 bytes).

    rand_chacha uses a 64-bit block counter split across state words 12..13
    with zero nonce words 14..15; we emulate via (counter_lo, counter_hi).
    """

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self.key = bytes(seed)
        self.counter = 0
        self.buf = b""

    def _refill(self):
        lo = self.counter & _MASK
        hi = (self.counter >> 32) & _MASK
        nonce = struct.pack("<3I", hi, 0, 0)
        self.buf += chacha20_block(self.key, lo, nonce)
        self.counter += 1

    def next_bytes(self, n: int) -> bytes:
        while len(self.buf) < n:
            self._refill()
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def next_u32(self) -> int:
        return int.from_bytes(self.next_bytes(4), "little")

    def next_u64(self) -> int:
        return int.from_bytes(self.next_bytes(8), "little")

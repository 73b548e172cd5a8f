# Copied from ckb_zkp_tpu/schemes/marlin/fs_rng.py (host ints only): the port keeps its own copy.
"""Marlin's Fiat-Shamir RNG: merlin-hashed seed chain driving ChaCha20.

Parity: ckb-zkp marlin/src/fs_rng.rs:11-70 (seed = H(seed || new)),
plus arkworks-compatible rejection sampling for field elements.
"""

from __future__ import annotations

from ...transcript import ChaChaRng, Transcript


class FiatShamirRng:
    def __init__(self, seed_material: bytes):
        t = Transcript(b"MARLINSEED")
        t.append_message(b"Seed", seed_material)
        self.seed = t.challenge_bytes(b"x", 32)
        self.r = ChaChaRng(self.seed)

    def absorb(self, material: bytes) -> None:
        t = Transcript(b"MARLINSEED")
        t.append_message(b"Seed", material + self.seed)
        self.seed = t.challenge_bytes(b"x", 32)
        self.r = ChaChaRng(self.seed)

    # --- rand sampling (mirrors ark UniformRand) ---
    def rand_fr(self, p: int) -> int:
        """Rejection sampling over 64-bit limbs, top bits shaved (ark Fp::rand)."""
        bits = p.bit_length()
        n64 = (bits + 63) // 64
        shave = n64 * 64 - bits
        mask = (1 << (n64 * 64 - shave)) - 1
        while True:
            v = int.from_bytes(self.r.next_bytes(n64 * 8), "little") & mask
            if v < p:
                return v

    def rand_u128(self) -> int:
        lo = self.r.next_u64()
        hi = self.r.next_u64()
        return lo | (hi << 64)

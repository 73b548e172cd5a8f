# Copied from ckb_zkp_tpu/transcript/__init__.py (host ints only): the port keeps its own copy.
"""Fiat–Shamir transcript machinery (host-side, byte-compatible).

Two mechanisms, mirroring the reference (SURVEY.md §1 cross-cutting):
merlin transcripts (bulletproofs/spartan/libra/hyrax) and digest-chained
ChaCha20 FS-RNG (marlin/plonk).
"""

from .chacha import ChaChaRng, chacha20_block
from .keccak import keccak_f1600, sha3_256
from .merlin import Strobe128, Transcript

__all__ = [
    "ChaChaRng",
    "chacha20_block",
    "keccak_f1600",
    "sha3_256",
    "Strobe128",
    "Transcript",
]

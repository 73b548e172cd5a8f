"""arkworks-v0.2-compatible canonical (de)serialization: the port's copy
of the JAX package's `serialize/ark.py` (the field and point codecs that
the Groth16 key and proof bytes use).

Conventions (ark-serialize 0.2):

- Fp: little-endian canonical integer, ceil(bits/64)*8 bytes.
- Fp2: c0 || c1.
- Short-Weierstrass affine, compressed: x with 2 flag bits in the top bits of
  the FINAL byte — PositiveY = 1<<7, Infinity = 1<<6, NegativeY = 0; the
  infinity point serializes x = 0 with the infinity flag. "Positive" means
  y > p - y as integers.
- Vec<T>: u64 little-endian length then elements.
"""

from .ark import FieldCodec, G1Codec, G2Codec, read_u64, write_u64

__all__ = ["FieldCodec", "G1Codec", "G2Codec", "read_u64", "write_u64"]

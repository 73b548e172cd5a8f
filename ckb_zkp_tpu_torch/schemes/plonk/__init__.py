# Copied from ckb_zkp_tpu/schemes/plonk/__init__.py (word for word; its imports resolve inside the port): the port keeps its own copy.
"""PLONK with 4 wire columns + q_arith and copy-constraint permutations.

Parity: ckb-zkp plonk/src/ — Composer gate API
(constrain_to_constant / assert_equal / create_add_gate / create_mul_gate),
selector+sigma indexing over domains n and 4n, the 3-round AHP (wires,
permutation accumulator z, quotient quad-split t_0..t_3), linear-combination
openings over the KZG PC, and the Digest-chained ChaCha FS-RNG (Blake2s).
"""

from .composer import Composer
from .plonk import Plonk, default_ks

__all__ = ["Composer", "Plonk", "default_ks"]

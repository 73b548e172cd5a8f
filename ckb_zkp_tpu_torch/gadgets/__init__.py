# Copied from ckb_zkp_tpu/gadgets/__init__.py (host ints only): the port keeps its own copy.
"""Circuit gadget library over the R1CS front-end.

Parity target: ckb-zkp gadgets/src (8.9k LoC): AbstractHash
protocol, MiMC (native + gadget, LongsightF322p3), boolean/AllocatedBit
algebra (incl. sha256 ch/maj), UInt32, MultiEq, SHA-256, BLAKE2s,
AllocatedFr, rangeproof, and the TestConstraintSystem debugging backend.
"""

from . import blake2s, cbmt, lookup, mimc, poseidon, rescue, sha256
from .abstract_hash import AbstractHash, AbstractHashOutput
from .boolean import AllocatedBit, Boolean, u64_into_boolean_vec_le
from .fr import AllocatedFr
from .multieq import MultiEq
from .rangeproof import enforce_greater_than
from .test_constraint_system import TestConstraintSystem
from .uint32 import UInt32

__all__ = [
    "mimc",
    "sha256",
    "blake2s",
    "poseidon",
    "rescue",
    "lookup",
    "cbmt",
    "AbstractHash",
    "AbstractHashOutput",
    "AllocatedBit",
    "Boolean",
    "u64_into_boolean_vec_le",
    "AllocatedFr",
    "MultiEq",
    "UInt32",
    "enforce_greater_than",
    "TestConstraintSystem",
]

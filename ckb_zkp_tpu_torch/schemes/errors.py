# Copied from ckb_zkp_tpu/schemes/errors.py (host ints only): the port keeps its own copy.
"""Scheme-level errors (parity: per-scheme error enums, e.g.
ckb-zkp marlin/src/errors.rs, plonk/src/error.rs)."""


class SchemeError(Exception):
    pass


class DegreeOutOfBound(SchemeError):
    pass


class HidingBoundError(SchemeError):
    pass


class VerificationError(SchemeError):
    pass

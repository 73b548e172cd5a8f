# Copied from ckb_zkp_tpu/schemes/hyrax/__init__.py (the package's exports): the port keeps its own copy.
"""Hyrax: doubly-efficient zk-GKR with data-parallel proving.

Parity: ckb-zkp hyrax/src/ — n identical circuit copies proven at
once, per-layer zero-knowledge sumchecks (three phases: instance bits, left
gate bits, right gate bits) with committed round polynomials opened through
a batched sigma protocol, and sqrt-matrix witness commitments opened with
the Bullet-reduce log-dot-product argument.
"""

from .circuit import Circuit, Gate, Layer
from .hyrax_proof import HyraxProof
from .params import Parameters

__all__ = ["Circuit", "Gate", "Layer", "HyraxProof", "Parameters"]

# Copied from ckb_zkp_tpu/schemes/libra/__init__.py (the package's exports): the port keeps its own copy.
"""Libra: linear-time-prover GKR over layered arithmetic circuits.

Parity: ckb-zkp libra/src/ — this round implements the layered
circuit model (circuit.rs) and the plain `LinearGKRProof`
(libra_linear_gkr.rs) and the zk variant `ZKLinearGKRProof`
(libra_zk_linear_gkr.rs: committed sumcheck rounds + sigma opening proofs +
LogDotProduct witness openings).
"""

from .circuit import Circuit, Gate, Layer
from .linear_gkr import LinearGKRProof
from .zk_linear_gkr import Parameters, ZKLinearGKRProof

__all__ = ["Circuit", "Gate", "Layer", "LinearGKRProof", "Parameters", "ZKLinearGKRProof"]

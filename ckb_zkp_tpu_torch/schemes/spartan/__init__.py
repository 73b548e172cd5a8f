# Copied from ckb_zkp_tpu/schemes/spartan/__init__.py (the package's exports): the port keeps its own copy.
"""Spartan transparent zkSNARK (sumcheck + MLE + Pedersen/Hyrax commitments).

Parity: ckb-zkp spartan/src/ — both variants:
- **nizk**: r1cs_satisfied prover/verifier (witness packing commitments, two
  zero-knowledge sumchecks with per-round sigma proofs, knowledge/product/eq
  proofs, bullet IPA witness opening); matrix MLEs checked directly.
- **snark**: adds the SPARK sparse-MLE evaluation argument (snark.py):
  memory-in-the-head encoding committed at setup, grand-product memory
  checking via batched cubic sumchecks over layered product circuits, and
  bullet-IPA openings of the ops/mem/derefs vectors.
"""

from . import nizk, snark
from .polynomial import bound_poly_var_bot, eval_eq, eval_eq_x_y, evaluate_mle

__all__ = ["nizk", "snark", "eval_eq", "eval_eq_x_y", "evaluate_mle", "bound_poly_var_bot"]

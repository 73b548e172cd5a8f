"""Jax-free access to the reference package's shared host layers.

The JAX package (`ckb_zkp_tpu`) imports `jax` in its top-level
`__init__.py` and in `schemes/groth16/__init__.py`, so it cannot be
imported on a machine without JAX. Its host layers (exact Python-int
fields, curves, pairings, the R1CS front end, the benchmark circuits and
the Groth16 types and verifier) are jax-free files, and the port uses them
as they are: one source of truth, no copies.

This loader builds alias package modules under ``ckb_zkp_tpu_torch._ref``
whose ``__path__`` points at the reference package's directories, then
imports only the jax-free files through them. No ``__init__.py`` of the
reference runs, and ``sys.modules["ckb_zkp_tpu"]`` is never touched, so
the real JAX package can be imported beside the port in the same process.

The alias classes (for example ``AffinePoint``) are distinct from the
reference's classes: compare points by their ``(x, y, infinity)`` values.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
import types

_ALIAS = __name__.rsplit(".", 1)[0] + "._ref"

# alias packages (no __init__ executed) and the jax-free modules loaded
_PACKAGES = ("", "host", "r1cs", "schemes", "schemes.groth16")
_MODULES = (
    "host.field",
    "host.curves",
    "host.tower",
    "host.pairing",
    "r1cs.lc",
    "r1cs.system",
    "bench_circuits",
    "schemes.groth16.types",
    "schemes.groth16.verifier",
)


def _reference_dir() -> str:
    spec = importlib.util.find_spec("ckb_zkp_tpu")  # does not execute it
    if spec is None or not spec.submodule_search_locations:
        raise ImportError("the reference package ckb_zkp_tpu is not on the path")
    return list(spec.submodule_search_locations)[0]


def _load():
    root = _reference_dir()
    for pkg in _PACKAGES:
        name = _ALIAS + ("." + pkg if pkg else "")
        if name in sys.modules:
            continue
        mod = types.ModuleType(name)
        mod.__path__ = [os.path.join(root, *pkg.split(".")) if pkg else root]
        mod.__package__ = name
        sys.modules[name] = mod
    return {m: importlib.import_module(f"{_ALIAS}.{m}") for m in _MODULES}


_mods = _load()

AffinePoint = _mods["host.curves"].AffinePoint
get_curve = _mods["host.pairing"].get_curve
square_chain_shape = _mods["bench_circuits"].square_chain_shape
product_circuit_shape = _mods["bench_circuits"].product_circuit_shape
Parameters = _mods["schemes.groth16.types"].Parameters
Proof = _mods["schemes.groth16.types"].Proof
VerifyKey = _mods["schemes.groth16.types"].VerifyKey
PreparedVerifyingKey = _mods["schemes.groth16.types"].PreparedVerifyingKey
prepare_verifying_key = _mods["schemes.groth16.verifier"].prepare_verifying_key
verify_proof = _mods["schemes.groth16.verifier"].verify_proof

"""CLI: trusted setup / prove / verify with file artifacts.

The port of `ckb_zkp_tpu/cli/`. Parity: ckb-zkp cli/src/{setup.rs,
zkp_prove.rs, zkp_verify.rs}, with the same artifact conventions:
`setup_files/<scheme>-<curve>-<circuit>.pk|.vk|.universal_setup|.ipk` and
`proof_files/<scheme>-<curve>-<circuit>.proof.json` with hex payloads keyed
{circuit, scheme, curve, params, proof}. Every command runs on the card
unless `--device cpu` (or `device="cpu"`) asks for the CPU.
"""

from .main import main, prove_cmd, setup_cmd, verify_cmd

__all__ = ["main", "setup_cmd", "prove_cmd", "verify_cmd"]

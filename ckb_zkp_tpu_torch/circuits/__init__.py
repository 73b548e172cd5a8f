"""Demo circuits: the port's copies of the JAX package's `circuits/mini.py`,
the reference's golden-path circuit, and `circuits/hash.py`, the MiMC
preimage circuit (`power_on`/`power_off` build them with or without a
witness)."""

from .hash import Hash
from .mini import Mini

__all__ = ["Hash", "Mini"]

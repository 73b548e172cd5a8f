"""Demo circuits: the port's copy of the JAX package's `circuits/mini.py`,
the reference's golden-path circuit (`power_on`/`power_off` build it with
or without a witness)."""

from .mini import Mini

__all__ = ["Mini"]

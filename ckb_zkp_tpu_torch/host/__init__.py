"""Host-int fields, curves, the Fq12 tower and pairings (the port's own
copies of the JAX package's jax-free `host/` layer)."""

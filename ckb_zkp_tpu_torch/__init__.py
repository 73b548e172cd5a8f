"""ckb-zkp-tpu on PyTorch and CUDA: the Groth16 BN254 prover for one GPU.

A second implementation of the reference JAX package `ckb_zkp_tpu` beside
it. Module names mirror the reference (`ops/field.py`, `ops/msm.py`,
`schemes/groth16/prover.py`, ...). Host layers (Python-int fields, curves,
pairings, R1CS, the Groth16 verifier) are the reference's own jax-free
files, loaded by `_reference`. Every Pallas kernel on the prover's path is
a hand-written CUDA kernel under `csrc/`, bound with ctypes; on CPU
tensors each kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"

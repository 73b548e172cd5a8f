"""ckb-zkp-tpu on PyTorch and CUDA: Groth16 BN254 setup and prover, one GPU.

A second implementation of the reference JAX package `ckb_zkp_tpu` beside
it. Module names mirror the reference (`ops/field.py`, `ops/msm.py`,
`schemes/groth16/prover.py`, ...). The host layers (Python-int fields,
curves, pairings, R1CS, the benchmark circuits, the Groth16 types and
verifier) are the port's own copies of the reference's jax-free files: the
port imports nothing of the JAX package. Every Pallas kernel on the setup's
and the prover's paths is a hand-written CUDA kernel under `csrc/`, bound
with ctypes; on CPU tensors each kernel wrapper runs its plain PyTorch
version instead. Entry points run on the card (`device="cuda"`) unless the
caller asks for the CPU.
"""

__version__ = "0.1.0"

"""ckb-zkp-tpu on PyTorch and CUDA: Groth16 on BN254 and BLS12-381, one GPU.

A second implementation of the reference JAX package `ckb_zkp_tpu` beside
it. Module names mirror the reference (`ops/field.py`, `ops/msm.py`,
`schemes/groth16/prover.py`, ...). The host layers (Python-int fields,
curves, pairings, R1CS, the benchmark circuits, the Groth16 types and
verifier, the ark-0.2 codecs and the Mini circuit) are the port's own
copies of the reference's jax-free files: the port imports nothing of the
JAX package. Groth16 runs end to end (front ends, setup, prove, verify,
key and proof bytes) on both pairing curves: BN254's Fq at 8 32-bit words,
BLS12-381's at 12, every Fr at 8. Every Pallas kernel on the setup's
and the prover's paths is a hand-written CUDA kernel under `csrc/`, bound
with ctypes; on CPU tensors each kernel wrapper runs its plain PyTorch
version instead. Entry points run on the card (`device="cuda"`) unless the
caller asks for the CPU.
"""

__version__ = "0.1.0"

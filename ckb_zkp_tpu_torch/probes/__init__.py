"""On-card probes: ports of the JAX package's `scripts/probe_window*.py`,
`scripts/probe_scan*.py`, `scripts/probe_mxu*.py` and
`scripts/probe_dma.py`. Each runs on one CUDA card, holds its kernels
against their plain versions on a small input before it times anything,
and times with CUDA events on one stream.

    python3 -m ckb_zkp_tpu_torch.probes.window [--log2 21]
    python3 -m ckb_zkp_tpu_torch.probes.scan [--log2 21]
    python3 -m ckb_zkp_tpu_torch.probes.mxu
    python3 -m ckb_zkp_tpu_torch.probes.grid [--log2 21]
    python3 -m ckb_zkp_tpu_torch.probes.dma [--log2 21]
"""

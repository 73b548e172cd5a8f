"""Multi-process execution: one rank per device, over torch.distributed.

Port of the reference's `parallel/multihost.py` (`:1-76`). The reference
joins processes into one JAX runtime (`jax.distributed.initialize`) whose
device list spans every host. Here every process is one rank of a process
group: it runs this same program on its own device, and the sharded code
(`parallel/ntt.py`, `parallel/msm.py`, `create_proof_from_shape(mesh=)`)
exchanges blocks through the group's collectives. The backend is the
caller's: "nccl" when each rank has a card of its own, "gloo" on the CPU
(or for ranks that share one card, whose collectives then pass through the
host: `mesh.py`).

    init_multihost("host0:29500", num_processes=N, process_id=rank, backend="nccl")
    mesh = global_mesh()
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, rank_device


def init_multihost(coordinator: str, num_processes: int, process_id: int, backend: str,
                   device="cuda", timeout_s: float = 600.0) -> None:
    """Join this process into the group as rank `process_id` of
    `num_processes`, with rank 0's store at `coordinator` ("host:port").
    On "cuda" the rank's card (`rank_device`) becomes the current device.
    A collective that waits longer than `timeout_s` fails the rank instead
    of hanging it."""
    dev = rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="tcp://" + coordinator,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def global_mesh(device="cuda") -> Mesh:
    """1-D mesh over every rank of the job, each on its device."""
    return make_mesh(None, device)


def process_count() -> int:
    return dist.get_world_size()


def process_index() -> int:
    return dist.get_rank()


def shard_put(x, mesh: Mesh, fill=None):
    """This rank's row block of a host-replicated array (a tensor or a
    tuple of coordinate tensors), on the mesh's device. Every rank calls it
    with the same value. The rows are cut into `mesh.size` blocks of
    ceil(N / size); where N is not a multiple, `fill` (one row, or a tuple
    of rows) pads the last blocks."""
    if isinstance(x, tuple):
        fills = fill if fill is not None else (None,) * len(x)
        return tuple(shard_put(c, mesh, f) for c, f in zip(x, fills))
    n = x.shape[0]
    blk = -(-n // mesh.size)
    lo, hi = min(mesh.rank * blk, n), min((mesh.rank + 1) * blk, n)
    part = x[lo:hi].to(mesh.device)
    if hi - lo < blk:
        if fill is None:
            raise ValueError(f"shard_put: {n} rows are not a multiple of {mesh.size} ranks")
        pad = fill.to(mesh.device, part.dtype).expand(blk - (hi - lo), *part.shape[1:])
        part = torch.cat([part, pad])
    return part

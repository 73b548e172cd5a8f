"""The shard axis over the ranks of a torch.distributed group.

Port of the reference's `parallel/mesh.py` (`:1-20`). The reference's
`Mesh` is one controller's view of many devices (`shard_map`); here each
rank is a process with one device, so a mesh is the group's ranks along
the axis "shard", this rank's place on it and its device. The collectives
of the reference's sharded code are the group's, with the reference's
semantics: `all_to_all_tiled` is `jax.lax.all_to_all(..., tiled=True)`,
`all_gather_cat` is `jax.lax.all_gather(..., axis=0, tiled=True)`.

Each collective adds its seconds to the mesh's `stats` (the card is
synchronized around it), so a caller can tell compute from exchange.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

SHARD_AXIS = "shard"


def rank_device(device="cuda", rank: int | None = None) -> torch.device:
    """This rank's device: "cuda" is the card local_rank % device_count
    (LOCAL_RANK from the launcher, else the global rank); anything else as
    given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if rank is None:
        rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclass(frozen=True, eq=False)
class Mesh:
    """One rank per device along SHARD_AXIS. `shape[SHARD_AXIS]` is the
    rank count, as the reference's `mesh.shape[axis]`. `domains` holds the
    sharded NTT domains built for this mesh (`get_sharded_domain`), so
    their twiddle blocks live as long as the mesh."""

    size: int
    rank: int
    device: torch.device
    group: object = None
    stats: dict = field(default_factory=lambda: {"seconds": 0.0, "calls": 0, "bytes": 0})
    domains: dict = field(default_factory=dict)

    @property
    def shape(self) -> dict:
        return {SHARD_AXIS: self.size}


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """1-D mesh over the ranks of the initialized default group (the
    reference's first n devices: here every rank, one device each)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized "
                           "(init_multihost, or init_process_group)")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked, the group has {size} ranks "
                         "(one rank per device: start that many ranks)")
    return Mesh(size, dist.get_rank(), rank_device(device), dist.group.WORLD)


def _host_transport(mesh: Mesh, x: torch.Tensor) -> bool:
    """gloo runs all-to-all and all-gather on CPU tensors only: a CUDA
    tensor is copied to the host for the exchange and back after it. This
    moves bytes only; every product stays on the card."""
    return x.device.type == "cuda" and dist.get_backend(mesh.group) == "gloo"


class _Timed:
    def __init__(self, mesh: Mesh, x: torch.Tensor):
        self.mesh, self.cuda, self.nbytes = mesh, x.device.type == "cuda", x.numel() * x.element_size()

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.t = time.perf_counter()

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        st = self.mesh.stats
        st["seconds"] += time.perf_counter() - self.t
        st["calls"] += 1
        st["bytes"] += self.nbytes


def all_to_all_tiled(x: torch.Tensor, split_dim: int, concat_dim: int, mesh: Mesh):
    """`jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)`:
    x's `split_dim` is cut into `size` equal blocks, block j goes to rank
    j, and the blocks received are concatenated along `concat_dim` in rank
    order. `all_to_all_single` splits dim 0 only, so the blocks are stacked
    on a new leading dim first."""
    d = mesh.size
    if x.shape[split_dim] % d:
        raise ValueError(f"all_to_all_tiled: dim {split_dim} of {tuple(x.shape)} is not a "
                         f"multiple of {d} ranks")
    send = torch.stack(torch.tensor_split(x, d, dim=split_dim)).contiguous()
    with _Timed(mesh, send):
        if _host_transport(mesh, send):
            recv = torch.empty_like(send, device="cpu")
            dist.all_to_all_single(recv, send.cpu(), group=mesh.group)
            recv = recv.to(x.device)
        else:
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=mesh.group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


def all_gather_cat(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's x, concatenated along dim 0 in rank order (the
    reference's `all_gather(..., axis=0)` of row blocks)."""
    x = x.contiguous()
    with _Timed(mesh, x):
        if _host_transport(mesh, x):
            parts = [torch.empty_like(x, device="cpu") for _ in range(mesh.size)]
            dist.all_gather(parts, x.cpu(), group=mesh.group)
            out = torch.cat(parts).to(x.device)
        else:
            parts = [torch.empty_like(x) for _ in range(mesh.size)]
            dist.all_gather(parts, x, group=mesh.group)
            out = torch.cat(parts)
    return out

"""Multi-device parallelism: mesh, sharded MSM and NTT, over torch.distributed.

Port of the reference's `parallel/` (`__init__.py`), whose layer replaces
the reference's rayon loops with `shard_map` over a JAX mesh. Here a mesh
is the ranks of a process group, one rank per device: each rank proves
with its row block of points, scalars and transform rows, and the ranks
exchange blocks through the group's collectives (all-to-all for the
four-step NTT's transposes, all-gather for the MSM partials and h).
"""

from .mesh import SHARD_AXIS, Mesh, all_gather_cat, all_to_all_tiled, make_mesh
from .msm import msm_sharded
from .multihost import (global_mesh, init_multihost, process_count, process_index,
                        shard_put)
from .ntt import ShardedDomain, get_sharded_domain

__all__ = ["make_mesh", "msm_sharded", "ShardedDomain", "get_sharded_domain", "SHARD_AXIS",
           "Mesh", "all_gather_cat", "all_to_all_tiled", "global_mesh", "init_multihost",
           "process_count", "process_index", "shard_put"]

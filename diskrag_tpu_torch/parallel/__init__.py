"""Scale-out over several devices (counterpart of `diskrag_tpu/parallel/`):

  - index sharding: partitioned Vamana sub-indexes, one per mesh slot,
    per-shard top-k lists merged in shard order (`sharded`);
  - data-parallel query batches over a second mesh axis (`mesh`);
  - per-shard independent builds (`build_sharded`, `sharded_build_wave`);
  - the sharded host tier: per-shard compressed traversal on the devices,
    pools merged, one exact host rerank against the f32 record file
    (`host_tier`);
  - several processes, each building and searching its own shards, the
    per-shard lists all-gathered over `torch.distributed` (`multihost`).

`dryrun.dryrun_multichip` runs one step of each on tiny shapes.
"""

from diskrag_tpu_torch.parallel import multihost
from diskrag_tpu_torch.parallel.host_tier import ShardedHostTier
from diskrag_tpu_torch.parallel.mesh import Mesh, PlacedShards, make_mesh, place
from diskrag_tpu_torch.parallel.sharded import (
    ShardedIndex,
    build_sharded,
    load_sharded_index,
    save_sharded_index,
    sharded_build_wave,
    sharded_flat_search,
    sharded_search,
    shard_to_mesh,
)

__all__ = [
    "multihost",
    "ShardedHostTier",
    "make_mesh",
    "ShardedIndex",
    "build_sharded",
    "load_sharded_index",
    "save_sharded_index",
    "sharded_build_wave",
    "sharded_flat_search",
    "sharded_search",
    "shard_to_mesh",
    "Mesh",
    "PlacedShards",
    "place",
]

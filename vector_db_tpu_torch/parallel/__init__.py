from vector_db_tpu_torch.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
    shard_axis,
)
from vector_db_tpu_torch.parallel.sharded import (
    ShardedFlatIndex,
    ShardedHNSW,
    ShardedIVF,
)

__all__ = ["make_mesh", "make_mesh_2d", "shard_axis", "ShardedFlatIndex",
           "ShardedIVF", "ShardedHNSW"]

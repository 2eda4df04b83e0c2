from .mesh import (Mesh, init_distributed, make_mesh, make_mesh_for_batch,
    batch_sharding, shard_batch, replicated, all_reduce_sum, gather_rows)

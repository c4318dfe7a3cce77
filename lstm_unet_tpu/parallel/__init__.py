from .mesh import (  # noqa: F401
    data_sharding,
    make_mesh,
    mesh_axis_sizes,
    replicated_sharding,
    shard_batch,
    shard_state,
)

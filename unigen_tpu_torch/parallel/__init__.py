"""Data, ZeRO-3 and tensor parallelism over a (data, fsdp, model) mesh."""
from .mesh import AXES, Mesh, MeshAxes, current_mesh, initialize_distributed, make_mesh  # noqa: F401
from .partition import (Sharding, add_fsdp, gather_params, partition_batch,  # noqa: F401
                        partition_magvit, partition_qwen2, partition_siglip, partition_unigen,
                        sanitize_specs, shard_params, siglip_specs, unigen_specs)

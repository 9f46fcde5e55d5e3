"""Parallelism over `torch.distributed`: meshes, sharding rules, the
collectives and the process plumbing (one process per rank)."""

from cloud_server_tpu_torch.parallel.distributed import (  # noqa: F401
    broadcast_from_primary,
    global_mesh_config,
    initialize,
    is_primary,
    make_hybrid_mesh,
    spawn_ranks,
    sync_global_devices,
)
from cloud_server_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from cloud_server_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardingRules,
    DEFAULT_RULES,
    logical_to_sharding,
    shard_params,
)
from cloud_server_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_pipelined_forward,
    make_pipelined_hidden,
    make_pipelined_loss,
    pipeline_rules,
    pipeline_spmd,
)

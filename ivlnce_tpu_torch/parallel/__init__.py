from ivlnce_tpu_torch.parallel.mesh import (
    Mesh,
    lane_shards,
    local_devices,
    make_mesh,
    param_shardings,
)
from ivlnce_tpu_torch.parallel.tensor import (
    gathered,
    gathered_state_dict,
    shard_policy,
)
from ivlnce_tpu_torch.parallel.train import (
    ShardedTrainStep,
    sharded_train_step,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "lane_shards",
    "local_devices",
    "param_shardings",
    "shard_policy",
    "gathered",
    "gathered_state_dict",
    "ShardedTrainStep",
    "sharded_train_step",
]

from ivlnce_tpu_torch.parallel.mesh import (
    Mesh,
    lane_shards,
    local_devices,
    make_mesh,
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
    "ShardedTrainStep",
    "sharded_train_step",
]

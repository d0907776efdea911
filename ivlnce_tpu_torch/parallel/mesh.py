"""The device mesh of the data-parallel IL update: the PyTorch counterpart
of ``ivlnce_tpu/parallel/mesh.py``.

The JAX package lays a ``(data, model)`` mesh over its devices and lets
XLA insert the collectives. The port runs one process, which drives the
update over explicit ``torch.device``s: the ``data`` axis splits the
batch's lanes into contiguous blocks, one per device (``lane_shards``,
the role of ``batch_sharding(mesh, 1)``: the (T, N) arrays' lane axis),
and each device holds a replica of the weights (``parallel/train.py``,
the role of ``replicated``). A device may appear more than once: its
shards then run in turn on it with shared weights, as the CPU tests and
a one-card machine run them.

The ``model`` axis (tensor parallelism, ``param_shardings``) is not
ported: the JAX trainers never reach it (``_train_step_fn`` builds
``make_mesh(ndp)``), only ``__graft_entry__.dryrun_multichip`` does."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

MODEL_AXIS_TODO = (
    "the tensor-parallel 'model' axis (model_parallel > 1, JAX "
    "param_shardings) is not ported to the PyTorch port yet "
    "(ROADMAP.md section 1, item 3: parallel/ model axis)"
)


def local_devices(device_type: str = "cuda") -> List[torch.device]:
    """The devices of one type this process sees: ``cuda:0..k-1``, or the
    one CPU (the CPU counts as one device unless a caller lists it more
    than once)."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device type {device_type}")


@dataclass(frozen=True)
class Mesh:
    """The data axis's devices, in shard order; ``devices[0]`` leads: it
    holds the weights the optimizer steps and runs what needs the whole
    batch."""

    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": 1}

    @property
    def lead(self) -> torch.device:
        return self.devices[0]


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A ``(data, model)`` mesh over the first ``n_devices`` of
    ``devices`` (default: every visible card)."""
    if model_parallel != 1:
        if model_parallel < 1:
            raise ValueError(f"model_parallel={model_parallel}")
        raise NotImplementedError(MODEL_AXIS_TODO)
    devices = [torch.device(d) for d in
               (local_devices("cuda") if devices is None else devices)]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices))


def lane_shards(mesh: Mesh, n_lanes: int) -> List[Tuple[torch.device,
                                                         slice]]:
    """Each data shard's device and its contiguous block of lanes."""
    n = mesh.shape["data"]
    if n_lanes % n:
        raise ValueError(f"{n_lanes} lanes do not split over {n} devices")
    size = n_lanes // n
    return [(d, slice(i * size, (i + 1) * size))
            for i, d in enumerate(mesh.devices)]

"""The device mesh of the IL update: the PyTorch counterpart of
``ivlnce_tpu/parallel/mesh.py``.

The JAX package lays a ``(data, model)`` mesh over its devices and lets
XLA insert the collectives. The port runs one process, which drives the
update over explicit ``torch.device``s laid out as JAX's
``reshape(n // model_parallel, model_parallel)``: row ``i`` of the grid
is data shard ``i``, column ``j`` model shard ``j``, and ``grid[i][0]``
leads row ``i``.

- ``data`` splits the batch's lanes into contiguous blocks, one per row
  (``lane_shards``, the role of ``batch_sharding(mesh, 1)``: the (T, N)
  arrays' lane axis); each row holds a copy of the weights
  (``parallel/train.py``, the role of ``replicated`` over ``data``).
- ``model`` (tensor parallelism) holds each weight that
  ``param_shardings`` picks as contiguous slices of its output axis, slice
  ``j`` on ``grid[i][j]``, and everything else on the row's lead
  (``parallel/tensor.py``).

A device may appear more than once: the rows or slices that share it then
run in turn on it, as the CPU tests and a one-card machine run them."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch


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
    """The ``(data, model)`` grid of devices: ``grid[i]`` is data row
    ``i``'s model devices; ``grid[0][0]`` leads the mesh: it holds the
    replicated weights the optimizer steps and runs what needs the whole
    batch."""

    grid: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.grid), "model": len(self.grid[0])}

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """Each data row's lead, in shard order."""
        return tuple(row[0] for row in self.grid)

    @property
    def lead(self) -> torch.device:
        return self.grid[0][0]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh device is 'cuda' and no card is "
                               "visible")
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A ``(data, model)`` mesh over the first ``n_devices`` of
    ``devices`` (default: every visible card), ``model_parallel`` devices
    to a row."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel}")
    devices = [_device(d) for d in
               (local_devices("cuda") if devices is None else devices)]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    n = len(devices)
    if n % model_parallel != 0:
        raise ValueError(
            f"{n} devices not divisible by model_parallel={model_parallel}"
        )
    m = model_parallel
    return Mesh(tuple(tuple(devices[i:i + m]) for i in range(0, n, m)))


def lane_shards(mesh: Mesh, n_lanes: int) -> List[Tuple[torch.device,
                                                         slice]]:
    """Each data row's lead and its contiguous block of lanes."""
    n = mesh.shape["data"]
    if n_lanes % n:
        raise ValueError(f"{n_lanes} lanes do not split over {n} devices")
    size = n_lanes // n
    return [(d, slice(i * size, (i + 1) * size))
            for i, d in enumerate(mesh.devices)]


def param_shardings(
    named_tensors: Mapping[str, torch.Tensor],
    mesh: Mesh,
    min_weight_size: int = 1 << 15,
) -> Dict[str, Optional[int]]:
    """JAX's tensor-parallel rule in the port's layout: for each name, the
    axis its tensor is split along over ``model``, or None (replicated).
    A weight with at least ``min_weight_size`` elements and two or more
    axes is split along its output axis when that axis divides by the
    ``model`` size.

    The output axis is axis 0 of every weight the policies hold:
    ``nn.Linear`` (out, in), ``nn.Conv1d`` (out, in, 1), ``nn.Conv2d``
    OIHW, ``nn.Embedding`` (num, dim) and the recurrent ``weight_ih_l0``,
    ``weight_hh_l0`` and ``_reverse`` (G*H, .). The JAX package stores
    the convolutions HWIO (output axis -1) and the kernel-size-1 Conv1d
    projections 2-D, with the same element count and output size, so the
    rule picks the same weights in both layouts."""
    m = mesh.shape["model"]

    def rule(t: torch.Tensor) -> Optional[int]:
        if (m > 1 and t.dim() >= 2 and t.numel() >= min_weight_size
                and t.shape[0] % m == 0):
            return 0
        return None

    return {name: rule(t) for name, t in named_tensors.items()}

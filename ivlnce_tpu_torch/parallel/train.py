"""The data- and tensor-parallel IL update: the PyTorch counterpart of
``ivlnce_tpu/parallel/train.py``.

The JAX package jits the single-device train step over a ``(data,
model)`` mesh; XLA inserts the collectives, so its result is the
single-device step's on the whole batch. ``sharded_train_step`` keeps
that meaning in one process: its step takes ``train_step``'s arguments,
splits the (T, N) batch into blocks of lanes, one per data row of the
mesh (``mesh.lane_shards``), runs each block's forward through its row's
copy of the policy and returns the whole batch's loss terms and final
RNN states, after one optimizer step on the whole batch's gradient.

- The loss terms are the whole batch's: each shard adds its lanes' share
  (``train_loss``'s ``n_lanes`` and ``n_aux_rows``, the batch's lane
  count and its count of rows with a positive inflection weight, known on
  the host before the split), and the shards' shares add up.
- The map encoder's training-mode BatchNorm normalises with statistics
  over all T*N rows, or over each chunk of the T-major rows with
  ``TPU.train_encode_chunk`` (zero padding included). Each layer's
  statistics depend on every row's previous layer, so it cannot run
  shard by shard. Row 0's copy runs it over the whole batch, chunked
  as the one-device forward chunks it (``policy.encode_maps``), and
  sends each shard its rows' features (``map_features``, 2048 floats a
  row at 64^2 maps); autograd carries their gradients back. This keeps
  the one-device step's statistics exactly, at the price of the map
  encoder's work staying on row 0; the other design, shards
  exchanging per-layer statistics through an autograd-aware reduction,
  would spread that work but needs four collectives forward and four
  back per step and knows no chunks. ``nn.DataParallel`` (per-replica
  statistics) and ``SyncBatchNorm`` (a process group, no chunks) give
  neither meaning.
- Row 0's copy holds the weights the optimizer steps. With a ``model``
  axis (``mesh.shape["model"] > 1``) it is the policy ``shard_policy``
  split over row 0 (``parallel/tensor.py``), and the optimizer is built
  over its parameters: block ``j`` of a split weight, its gradient and
  its Adam moments live on ``grid[0][j]`` (JAX's
  ``param_shardings(opt_state)``), the rest on ``grid[0][0]``. Every
  other row whose devices differ holds a copy, made once per policy
  (``shard_policy(policy, mesh, i)``: block ``j`` on ``grid[i][j]``);
  after backward each copy's gradients are added onto row 0's, column by
  column (``torch.cuda.comm.reduce_add_coalesced``), the optimizer takes
  one step on the sum, the map encoder's running statistics are
  recomputed over the whole batch with the updated weights
  (``update_map_bn``), and every parameter and buffer is broadcast back
  into the copies, column by column (``broadcast_coalesced``), so they
  are equal on every row after each step. The optimizer's state and a
  checkpoint (``gathered_state_dict`` with a ``model`` axis) are a
  one-device run's. Copies are updated in place, so each one's kept
  bfloat16 cast copies (``models/nn.py``, keyed by version counters) are
  remade and cuDNN's GRU weights stay the parameters' own memory; the
  recurrent modules keep the train mode the trainer set.
- Rows on row 0's devices (every row on a one-card machine or the CPU)
  run in turn with row 0's weights: no copy, no collective.
- A shard's host arrays are uploaded straight to its row's lead
  (``models/il_update.py::to_device``).

The step returns, like ``train_step``, the detached loss terms and the
final RNN states, gathered by lane on the mesh's lead."""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ivlnce_tpu_torch.models.il_update import to_device, train_loss
from ivlnce_tpu_torch.parallel.mesh import Mesh, lane_shards
from ivlnce_tpu_torch.parallel.tensor import shard_policy, split_columns
from ivlnce_tpu_torch.utils import profiling

MAP_KEYS = ("occupancy_map", "semantic_map")


def _lane_rows(a, lanes: slice, t: int, n: int, device: torch.device,
               flat: bool) -> torch.Tensor:
    """The ``lanes`` of a (T, N) array, or of T-major (T*N, ...) rows when
    ``flat``, on ``device``; a host array's go to it in one upload."""
    rest = tuple(a.shape[1:]) if flat else ()
    part = a.reshape((t, n) + rest)[:, lanes]
    return to_device(part.reshape((-1,) + rest) if flat else part, device)


Row = Tuple[torch.device, ...]


class ShardedTrainStep:
    """A step with ``train_step``'s arguments and results over ``mesh``.
    The arrays may be host arrays or tensors; the policy lives on
    ``mesh.grid[0]``: on ``mesh.lead``, or split over row 0 by
    ``shard_policy`` when the mesh has a ``model`` axis."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._policy: Optional[nn.Module] = None
        # each data row's devices -> its copy of the policy, for the rows
        # whose devices differ from row 0's
        self.replicas: Dict[Row, nn.Module] = {}

    def _replicas_of(self, policy: nn.Module) -> Dict[Row, nn.Module]:
        """The copy on each row whose devices differ from row 0's, made on
        first use for this policy."""
        if self._policy is not policy:
            self._policy, self.replicas = policy, {}
        grid = self.mesh.grid
        for i, row in enumerate(grid):
            if row == grid[0] or row in self.replicas:
                continue
            if any(a == b for a, b in zip(row, grid[0])):
                raise ValueError(f"mesh rows {grid[0]} and {row} share a "
                                 "device in one column")
            with torch.no_grad():
                self.replicas[row] = shard_policy(policy, self.mesh, i)
        return self.replicas

    def _by_column(self, tensors, columns):
        """The indices of ``tensors`` grouped by their model column."""
        groups: Dict[int, list] = {}
        for i, t in enumerate(tensors):
            groups.setdefault(columns.get(id(t), 0), []).append(i)
        return groups

    def _reduce_grads(self, policy: nn.Module) -> None:
        """The copies' gradients added onto row 0's, column by column."""
        if not self.replicas:
            return
        from torch.cuda import comm

        lead = list(policy.parameters())
        copies = [list(r.parameters()) for r in self.replicas.values()]
        held = [i for i, p in enumerate(lead)
                if any(ps[i].grad is not None for ps in [lead] + copies)]

        def grad(p):
            return torch.zeros_like(p) if p.grad is None else p.grad

        columns = split_columns(policy)
        for idx in self._by_column([lead[i] for i in held],
                                   columns).values():
            idx = [held[k] for k in idx]
            summed = comm.reduce_add_coalesced(
                [[grad(ps[i]) for i in idx] for ps in [lead] + copies],
                destination=lead[idx[0]].device.index)
            for i, g in zip(idx, summed):
                lead[i].grad = g
        for replica in self.replicas.values():
            replica.zero_grad(set_to_none=True)

    def _broadcast(self, policy: nn.Module) -> None:
        """Every parameter and buffer of row 0 into the copies, column by
        column."""
        if not self.replicas:
            return
        from torch.cuda import comm

        def tensors(module):
            return list(itertools.chain(module.parameters(),
                                        module.buffers()))

        mine = tensors(policy)
        theirs = [tensors(r) for r in self.replicas.values()]
        columns = split_columns(policy)
        for j, idx in self._by_column(mine, columns).items():
            copies = comm.broadcast_coalesced(
                [mine[i].detach() for i in idx],
                [self.mesh.grid[0][j]] + [row[j] for row in self.replicas])
            with torch.no_grad():
                for replica, new in zip(theirs, copies[1:]):
                    for i, src in zip(idx, new):
                        replica[i].copy_(src)

    def __call__(self, policy, optimizer, observations, prev_actions,
                 episode_masks, tour_masks, corrected, weights, rnn_states,
                 use_progress: bool, alpha: float, update_map_bn: bool):
        lead = self.mesh.lead
        home = getattr(policy, "model_devices",
                       (next(policy.parameters()).device,))
        if home != self.mesh.grid[0]:
            raise ValueError(f"the policy is on {home}, the mesh's row 0 "
                             f"is {self.mesh.grid[0]} (a model axis takes "
                             "shard_policy(policy, mesh))")
        t, n = corrected.shape
        replicas = self._replicas_of(policy)
        n_aux_rows = int((torch.as_tensor(weights) > 0).sum())
        maps = map_features = None
        if hasattr(policy.net, "map_encoder"):
            with profiling.span("upload"):
                maps = [to_device(observations[k], lead) for k in MAP_KEYS]
            with profiling.span("train_encode"):
                map_features = policy.encode_maps(*maps, training=True)
        parts = []
        for row, (device, lanes) in zip(self.mesh.grid,
                                        lane_shards(self.mesh, n)):
            module = replicas.get(row, policy)

            def rows(a, flat=True):
                return _lane_rows(a, lanes, t, n, device, flat)

            with profiling.span("upload"):
                obs = {k: rows(v) for k, v in observations.items()
                       if maps is None or k not in MAP_KEYS}
                if map_features is not None:
                    obs["map_features"] = rows(map_features)
                args = (rows(prev_actions), rows(episode_masks, False),
                        rows(tour_masks, False), rows(corrected, False),
                        rows(weights, False), rnn_states[lanes].to(device))
            parts.append(train_loss(
                module, obs, *args, use_progress, alpha, n_lanes=n,
                n_aux_rows=n_aux_rows,
            ))
        loss, action_loss, aux_loss = (
            torch.stack([p[i].to(lead) for p in parts]).sum()
            for i in range(3))
        with profiling.span("backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        self._reduce_grads(policy)
        with profiling.span("optimizer"):
            optimizer.step()
        if update_map_bn:
            with profiling.span("map_bn_stats"):
                policy.net.map_encoder.update_running_stats(*maps)
        self._broadcast(policy)
        rnn_out = torch.cat([p[3].detach().to(lead) for p in parts], 0)
        return (loss.detach(), action_loss.detach(), aux_loss.detach(),
                rnn_out)


def sharded_train_step(mesh: Mesh) -> ShardedTrainStep:
    """The mesh counterpart of ``models/il_update.py::train_step`` over
    ``mesh`` (JAX ``sharded_train_step``): with a ``model`` axis, call it
    with ``shard_policy(policy, mesh)`` and an optimizer over that copy's
    parameters."""
    return ShardedTrainStep(mesh)

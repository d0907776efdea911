"""Tensor parallelism over a mesh's ``model`` axis: the port's
counterpart of placing a policy's weights with
``ivlnce_tpu/parallel/mesh.py::param_shardings``.

JAX shards each big weight's output axis over ``model`` and lets XLA
insert the all-gathers its consumers need. The port does the same by
hand, in one process (Megatron's column-parallel split):

- ``shard_policy(policy, mesh, row)`` copies a policy onto mesh row
  ``row``: each weight ``param_shardings`` picks becomes ``Slices``, ``m``
  contiguous blocks of its axis 0, block ``j`` on ``grid[row][j]``;
  everything else sits on the row's lead ``grid[row][0]``. The module that
  held the weight becomes its split counterpart: ``ColumnLinear``,
  ``ColumnConv`` (``nn.Conv1d``, ``nn.Conv2d``), ``VocabEmbedding``,
  ``GateSplitGRU``, ``GateSplitLSTM``. A split layer keeps its bias's
  matching rows beside each weight block.
- A split layer copies its input from the lead to each model device
  (``copy_to``), computes its block of output channels there, and gathers
  the blocks along the channel axis onto the lead (``gather_to``). Every
  consumer thus sees the whole output on the lead, as GroupNorm,
  BatchNorm, residual adds and the gate arithmetic need it. Splitting
  output channels leaves each output's sum as it was.
- The embedding is split over its vocabulary: each block looks up the ids
  in its range and gives zeros elsewhere, and the blocks are summed (one
  value and zeros: exact).
- The GRU and LSTM compute their gate pre-activations ``x W_ih^T + b_ih``
  and ``h W_hh^T + b_hh`` column-parallel where the weight is split, and
  the gate arithmetic on the lead (``models/rnn.py``'s ``gru_gates``,
  ``lstm_gates``: JAX's ``gru_cell``, ``lstm_cell``).
- ``gathered_state_dict`` and ``gathered`` give the one-device names and
  whole tensors back (a sharded ``jax.Array`` is likewise the whole array
  to its user): to compare, save or load into a one-device policy.

Across distinct cards ``copy_to`` and ``gather_to`` are autograd
functions over ``torch.cuda.comm`` (broadcast / reduce_add, gather /
scatter); where the devices repeat (the CPU, or one card listed ``m``
times) they are plain differentiable ``.to`` and ``cat``. No path gathers
a whole weight onto one device to compute with it.

``TPU.compute_dtype`` bfloat16 casts a split layer's blocks where they
lie (``models/nn.py::apply_cast`` copies and casts the module)."""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ivlnce_tpu_torch.models.rnn import bi_lstm_cells, gru_gates, lstm_gates
from ivlnce_tpu_torch.parallel.mesh import Mesh, param_shardings


# -- the two collectives ------------------------------------------------------
def _cross_card(devices: Sequence[torch.device]) -> bool:
    return (len(devices) > 1 and len(set(devices)) == len(devices)
            and all(d.type == "cuda" for d in devices))


class _CopyTo(torch.autograd.Function):
    """Forward: broadcast to the cards; backward: add the gradients onto
    the source."""

    @staticmethod
    def forward(ctx, devices, x):
        from torch.cuda import comm

        ctx.source = x.device.index
        return tuple(comm.broadcast(x, devices))

    @staticmethod
    def backward(ctx, *grads):
        from torch.cuda import comm

        return None, comm.reduce_add(grads, destination=ctx.source)


class _GatherTo(torch.autograd.Function):
    """Forward: concatenate the cards' blocks on ``destination``; backward:
    split the gradient back to each block's card."""

    @staticmethod
    def forward(ctx, dim, destination, *parts):
        from torch.cuda import comm

        ctx.dim = dim
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.devices = [p.device.index for p in parts]
        return comm.gather(parts, dim, destination)

    @staticmethod
    def backward(ctx, grad):
        from torch.cuda import comm

        return (None, None) + tuple(comm.scatter(
            grad.contiguous(), ctx.devices, ctx.sizes, ctx.dim))


def copy_to(x: torch.Tensor, devices: Sequence[torch.device]
            ) -> List[torch.Tensor]:
    """``x`` on each of ``devices``; gradients flow back onto ``x``."""
    if _cross_card(devices) and x.device in devices:
        return list(_CopyTo.apply(tuple(devices), x))
    return [x.to(d) for d in devices]


def gather_to(parts: Sequence[torch.Tensor], dim: int,
              device: torch.device) -> torch.Tensor:
    """The blocks concatenated along ``dim`` on ``device``; each block's
    gradient flows back to its own device."""
    devices = [p.device for p in parts]
    if _cross_card(devices):
        return _GatherTo.apply(dim % parts[0].dim(), device, *parts)
    return torch.cat([p.to(device) for p in parts], dim)


# -- split tensors and layers -------------------------------------------------
class Slices(nn.ParameterList):
    """One weight as ``len(devices)`` equal contiguous blocks of its axis
    0, block ``j`` on ``devices[j]``."""

    def __init__(self, tensor: torch.Tensor, devices: Sequence[torch.device]):
        size = tensor.shape[0] // len(devices)
        super().__init__([
            nn.Parameter(tensor[j * size:(j + 1) * size].detach().to(
                d, copy=True), tensor.requires_grad)
            for j, d in enumerate(devices)])

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self]


def _column(op: Callable, x: torch.Tensor, weight: Slices,
            bias: Optional[Slices], dim: int) -> torch.Tensor:
    """``op(x, w_j, b_j)`` on each block's device, gathered along ``dim``
    on the first block's."""
    devices = weight.devices
    biases = [None] * len(devices) if bias is None else list(bias)
    parts = [op(xj, w, b) for xj, w, b in zip(copy_to(x, devices), weight,
                                              biases)]
    return gather_to(parts, dim, devices[0])


def _product(x: torch.Tensor, weight, bias) -> torch.Tensor:
    """``x weight^T + bias``, column-parallel when the weight is split."""
    if isinstance(weight, Slices):
        return _column(F.linear, x, weight, bias, -1)
    return F.linear(x, weight, bias)


def _split_pair(module: nn.Module, weight: str, bias: Optional[str],
                devices) -> None:
    """Replace ``module.weight`` (and its bias) by ``Slices``."""
    for name in (weight, bias):
        if name is not None and getattr(module, name) is not None:
            t = module._parameters.pop(name)
            setattr(module, name, Slices(t, devices))


class ColumnLinear(nn.Module):
    """``nn.Linear`` with its output features split over the devices."""

    def __init__(self, linear: nn.Linear, devices):
        super().__init__()
        self.weight = Slices(linear.weight, devices)
        self.bias = (None if linear.bias is None
                     else Slices(linear.bias, devices))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _column(F.linear, x, self.weight, self.bias, -1)


class ColumnConv(nn.Module):
    """``nn.Conv1d`` / ``nn.Conv2d`` with its output channels split over
    the devices."""

    def __init__(self, conv: nn.Module, devices):
        super().__init__()
        if conv.padding_mode != "zeros" or conv.groups != 1:
            raise NotImplementedError(f"no split form of {conv}")
        self.op = F.conv1d if isinstance(conv, nn.Conv1d) else F.conv2d
        self.stride, self.padding, self.dilation = (conv.stride,
                                                    conv.padding,
                                                    conv.dilation)
        self.weight = Slices(conv.weight, devices)
        self.bias = (None if conv.bias is None
                     else Slices(conv.bias, devices))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def op(xj, w, b):
            return self.op(xj, w, b, self.stride, self.padding,
                           self.dilation)
        return _column(op, x, self.weight, self.bias, 1)


class VocabEmbedding(nn.Module):
    """``nn.Embedding`` with its rows (the vocabulary) split over the
    devices: each block gives the rows of the ids in its range and zeros
    elsewhere, and the blocks are summed on the first device. The padding
    row keeps no gradient, as in ``nn.Embedding``."""

    def __init__(self, embedding: nn.Embedding, devices):
        super().__init__()
        if embedding.max_norm is not None or embedding.sparse:
            raise NotImplementedError(f"no split form of {embedding}")
        self.padding_idx = embedding.padding_idx
        self.weight = Slices(embedding.weight, devices)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        devices = self.weight.devices
        parts, lo = [], 0
        for w, ids_j in zip(self.weight, copy_to(ids, devices)):
            hi = lo + w.shape[0]
            inside = (ids_j >= lo) & (ids_j < hi)
            pad = self.padding_idx
            pad = pad - lo if pad is not None and lo <= pad < hi else None
            rows = F.embedding(torch.where(inside, ids_j - lo, 0), w, pad)
            parts.append(rows.masked_fill(~inside[..., None], 0)[None])
            lo = hi
        return gather_to(parts, 0, devices[0]).sum(0)


def _check_rnn(rnn: nn.RNNBase, bidirectional: bool) -> None:
    if (rnn.num_layers != 1 or rnn.bidirectional != bidirectional
            or not rnn.bias or rnn.proj_size):
        raise NotImplementedError(f"no split form of {rnn}")


class GateSplitGRU(nn.Module):
    """One-layer ``nn.GRU`` (sequence-first) whose split weights give
    their gate rows column-parallel; same call and results as the GRU."""

    def __init__(self, gru: nn.GRU, split: Sequence[str], devices):
        super().__init__()
        _check_rnn(gru, False)
        self.hidden_size = gru.hidden_size
        for name, p in gru.named_parameters():
            setattr(self, name, p)
        for kind in ("ih", "hh"):
            if f"weight_{kind}_l0" in split:
                _split_pair(self, f"weight_{kind}_l0", f"bias_{kind}_l0",
                            devices)

    def forward(self, xs: torch.Tensor, h0: torch.Tensor):
        """(T, B, I) inputs and (1, B, H) state -> ((T, B, H), (1, B, H))."""
        h, outs = h0[0], []
        for x in xs:
            h = gru_gates(_product(x, self.weight_ih_l0, self.bias_ih_l0),
                          _product(h, self.weight_hh_l0, self.bias_hh_l0), h)
            outs.append(h)
        return torch.stack(outs), h[None]


class GateSplitLSTM(nn.Module):
    """One-layer bidirectional ``nn.LSTM`` whose split weights give their
    gate rows column-parallel; ``models/rnn.py::bi_lstm_padded`` runs it
    through ``padded``."""

    def __init__(self, lstm: nn.LSTM, split: Sequence[str], devices):
        super().__init__()
        _check_rnn(lstm, True)
        self.hidden_size = lstm.hidden_size
        for name, p in lstm.named_parameters():
            setattr(self, name, p)
        for sfx in ("", "_reverse"):
            for kind in ("ih", "hh"):
                if f"weight_{kind}_l0{sfx}" in split:
                    _split_pair(self, f"weight_{kind}_l0{sfx}",
                                f"bias_{kind}_l0{sfx}", devices)

    def _cell(self, sfx: str):
        def step(x, h, c):
            gi = _product(x, getattr(self, f"weight_ih_l0{sfx}"),
                          getattr(self, f"bias_ih_l0{sfx}"))
            gh = _product(h, getattr(self, f"weight_hh_l0{sfx}"),
                          getattr(self, f"bias_hh_l0{sfx}"))
            return lstm_gates(gi, gh, c)
        return step

    def padded(self, xs: torch.Tensor, lengths: torch.Tensor):
        return bi_lstm_cells(self._cell(""), self._cell("_reverse"),
                             self.hidden_size, xs, lengths)


def _split_layer(module: nn.Module, split: List[str], devices) -> nn.Module:
    """The split counterpart of ``module``, whose own parameters named in
    ``split`` are to be split."""
    if isinstance(module, nn.Linear):
        return ColumnLinear(module, devices)
    if isinstance(module, (nn.Conv1d, nn.Conv2d)):
        return ColumnConv(module, devices)
    if isinstance(module, nn.Embedding):
        return VocabEmbedding(module, devices)
    if isinstance(module, nn.GRU):
        return GateSplitGRU(module, split, devices)
    if isinstance(module, nn.LSTM):
        return GateSplitLSTM(module, split, devices)
    raise NotImplementedError(
        f"no split form of {type(module).__name__} ({split})")


# -- the policy ---------------------------------------------------------------
def _moved(p: nn.Parameter, device: torch.device) -> nn.Parameter:
    if p.device == device:
        return p
    return nn.Parameter(p.detach().to(device), p.requires_grad)


def _place(policy: nn.Module, devices) -> None:
    """Slice ``j`` of every ``Slices`` onto ``devices[j]``, every other
    parameter and buffer onto ``devices[0]``; kept bfloat16 cast copies
    are dropped."""
    for module in policy.modules():
        if "_cast_copy" in module.__dict__:
            module.__dict__["_cast_copy"] = None
        if isinstance(module, Slices):
            for (k, p), d in zip(list(module._parameters.items()), devices):
                module._parameters[k] = _moved(p, d)
            continue
        for k, p in list(module._parameters.items()):
            if p is not None:
                module._parameters[k] = _moved(p, devices[0])
        for k, b in list(module._buffers.items()):
            if b is not None:
                module._buffers[k] = b.to(devices[0])


def is_split(policy: nn.Module) -> bool:
    return any(isinstance(m, Slices) for m in policy.modules())


def shard_policy(policy: nn.Module, mesh: Mesh, row: int = 0
                 ) -> nn.Module:
    """A copy of ``policy`` for mesh row ``row``: every weight
    ``param_shardings`` picks split over ``mesh.grid[row]``, everything
    else on ``mesh.grid[row][0]``. A policy already split (another row's
    copy) keeps its split and is moved onto the row's devices."""
    devices = mesh.grid[row]
    out = copy.deepcopy(policy)
    if not is_split(policy):
        rule = param_shardings(policy.state_dict(keep_vars=True), mesh)
        picked = {k for k, axis in rule.items() if axis is not None}
        for name, module in list(out.named_modules()):
            prefix = f"{name}." if name else ""
            split = [k for k in module._parameters
                     if prefix + k in picked]
            if not split:
                continue
            picked -= {prefix + k for k in split}
            parent, _, attr = name.rpartition(".")
            setattr(out.get_submodule(parent), attr,
                    _split_layer(module, split, devices))
        if picked:
            raise NotImplementedError(f"no split form for {sorted(picked)}")
    _place(out, devices)
    out.model_devices = tuple(devices)
    return out


def gathered(policy: nn.Module,
             value: Callable[[nn.Parameter], Optional[torch.Tensor]]
             = lambda p: p,
             buffers: bool = False) -> Dict[str, torch.Tensor]:
    """``value`` of each parameter (a split one's blocks concatenated on
    the first block's device) under its one-device name, detached; the
    parameters whose ``value`` is None are left out. ``buffers`` adds the
    persistent buffers (the state_dict's)."""
    out = {}
    for name, module in policy.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(module, Slices):
            parts = [value(p) for p in module]
            if all(t is not None for t in parts):
                lead = parts[0].device
                out[name] = torch.cat([t.detach().to(lead) for t in parts])
            continue
        for k, p in module._parameters.items():
            t = None if p is None else value(p)
            if t is not None:
                out[prefix + k] = t.detach()
        if buffers:
            for k, b in module._buffers.items():
                if b is not None and k not in module._non_persistent_buffers_set:
                    out[prefix + k] = b.detach()
    return out


def gathered_state_dict(policy: nn.Module) -> Dict[str, torch.Tensor]:
    """The one-device policy's state_dict (names, shapes, values) of a
    split policy, each tensor whole on its row's lead."""
    return gathered(policy, buffers=True)


def split_columns(policy: nn.Module) -> Dict[int, int]:
    """The model column of each parameter: ``j`` for block ``j`` of a
    split weight, 0 for the rest (the row's lead), by ``id``."""
    columns = {id(p): 0 for p in policy.parameters()}
    for module in policy.modules():
        if isinstance(module, Slices):
            columns.update({id(p): j for j, p in enumerate(module)})
    return columns


"""Layers the MapCMA path uses beyond ``torch.nn``: the PyTorch
counterpart of ``ivlnce_tpu/models/nn.py``."""

from __future__ import annotations

import copy
import itertools
from typing import Dict, Optional

import torch
from torch import nn
from torch.func import functional_call


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference _attn (map_cma_policy.py:266-274): q (B, C), k/v
    (B, C, I); mask True marks invalid positions."""
    logits = torch.bmm(q[:, None, :], k)[:, 0]
    if mask is not None:
        logits = logits - mask.float() * 1e8
    attn = torch.softmax(logits * scale, dim=1)
    return torch.bmm(v, attn[:, :, None])[:, :, 0]


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float one-hot over a new last axis; labels >= num_classes give an
    all-zero row (as jax.nn.one_hot)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.long()[..., None] == classes).float()


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """``TPU.compute_dtype``: "bfloat16" selects bfloat16, any other value
    float32 (None), as the JAX package's ``_compute_dtype`` does."""
    return torch.bfloat16 if name == "bfloat16" else None


def cast_tree(module: nn.Module, dtype: torch.dtype
              ) -> Dict[str, torch.Tensor]:
    """The module's parameters and buffers by name, the floating ones cast
    to ``dtype`` (JAX nn.py:41-50). The cast is differentiable: gradients
    reach the module's own tensors."""
    return {name: t.to(dtype) if t.is_floating_point() else t
            for name, t in itertools.chain(module.named_parameters(),
                                           module.named_buffers())}


def _drop_cast_copy(module: nn.Module, incompatible_keys) -> None:
    module.__dict__["_cast_copy"] = None


def _cast_key(module: nn.Module, dtype: torch.dtype, tensors, versioned):
    """What the kept cast copy of ``module`` was made from: the dtype, the
    train/eval mode, where the first tensor lives (a ``.to()`` moves it)
    and the sum of the version counters (an in-place update, as an
    optimizer step or a running-statistics update, moves it; inference
    tensors keep none)."""
    first = tensors[0]
    return (dtype, module.training, first.device, first.data_ptr(),
            sum(t._version for t in versioned))


def apply_cast(module: nn.Module, dtype: torch.dtype, *args, **kwargs):
    """``module(*args, **kwargs)`` with its floating parameters and buffers
    cast to ``dtype``. The module's own tensors, which its ``state_dict``
    and the optimizer see, keep their dtype, as the JAX package's master
    weights stay float32. While autograd records and a parameter requires
    a gradient, each call casts them afresh (``cast_tree``), so gradients
    reach them. Otherwise a cast copy of the module is kept beside it and
    made anew after a ``load_state_dict``, a ``.to()``, a change of mode
    or an in-place update of its tensors (``_cast_key``), so a call adds
    to the module's own host work only a sum of version counters."""
    if torch.is_grad_enabled() and any(p.requires_grad
                                       for p in module.parameters()):
        return functional_call(module, cast_tree(module, dtype), args,
                               kwargs)
    if "_cast_copy" not in module.__dict__:
        module.register_load_state_dict_post_hook(_drop_cast_copy)
        module.__dict__["_cast_copy"] = None
    cached = module.__dict__["_cast_copy"]
    if cached is not None:
        tensors, versioned, key, copied = cached
        if _cast_key(module, dtype, tensors, versioned) != key:
            cached = None
    if cached is None:
        tensors = list(itertools.chain(module.parameters(),
                                       module.buffers()))
        versioned = [t for t in tensors if not t.is_inference()]
        with torch.no_grad():
            copied = copy.deepcopy(module).to(dtype).requires_grad_(False)
        key = _cast_key(module, dtype, tensors, versioned)
        module.__dict__["_cast_copy"] = (tensors, versioned, key, copied)
    return copied(*args, **kwargs)

"""Semantic map encoder: the PyTorch counterpart of
``ivlnce_tpu/models/map_encoder.py`` (reference map_encoder.py). Four
CBRA blocks (7x7 same conv -> BatchNorm -> ReLU -> 2x2 avg pool) over 1
occupancy + 13 one-hot semantic channels.

BatchNorm follows the JAX package, not ``nn.BatchNorm2d``'s train mode:
the training forward (``training=True``) normalises with the batch's
statistics (biased variance) and leaves the running statistics alone;
after the optimizer step the trainer calls ``update_running_stats``, which
recomputes them layer by layer with the updated weights (momentum 0.1,
unbiased variance; JAX map_encoder.py:75-94, nn.py:220-233)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ivlnce_tpu_torch.models.nn import apply_cast, one_hot

BN_MOMENTUM = 0.1


class CBRA(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        # conv.0 / conv.1: the reference checkpoints' names
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, 7, padding=3),
            nn.BatchNorm2d(cout),
        )

    def normalize(self, pre: torch.Tensor, training: bool) -> torch.Tensor:
        """BatchNorm of the conv output: batch statistics when
        ``training``, else the running ones; never updates them."""
        bn = self.conv[1]
        if training:
            return F.batch_norm(pre, None, None, bn.weight, bn.bias, True,
                                0.0, bn.eps)
        return F.batch_norm(pre, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        x = self.normalize(self.conv[0](x), training)
        return F.avg_pool2d(F.relu(x), 2)


class SemanticMapEncoder(nn.Module):
    def __init__(self, map_hw: int, num_semantic_classes: int = 13,
                 ch: int = 32, last_ch_mult: int = 4):
        super().__init__()
        self.num_semantic_classes = num_semantic_classes
        widths = [ch, ch * 2, ch * 4, ch * last_ch_mult]
        blocks, prev = [], 1 + num_semantic_classes
        for w in widths:
            blocks.append(CBRA(prev, w))
            prev = w
        self.cnn = nn.Sequential(*blocks)
        self.output_shape = (widths[-1], map_hw // 16, map_hw // 16)

    def _inputs(self, occupancy: torch.Tensor, semantic: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
        """The 14 input channels in ``dtype``."""
        occ = occupancy.to(dtype)[:, None]
        sem = one_hot(semantic, self.num_semantic_classes).to(dtype)
        return torch.cat([occ, sem.permute(0, 3, 1, 2)], dim=1)

    def forward(self, occupancy: torch.Tensor, semantic: torch.Tensor,
                training: bool = False,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(B, R, C) uint8 maps -> (B, C_out, R/16, C/16); ``training``
        normalises with batch statistics. ``dtype`` (``TPU.compute_dtype``)
        runs the inputs and the stack, its weights and running statistics
        cast (``apply_cast``), in that dtype, and returns float32; a
        training forward ignores it and stays in the weights' dtype (JAX
        map_encoder.py:44-72, cma.py:173-183)."""
        if dtype is None or training:
            x = self._inputs(occupancy, semantic,
                             self.cnn[0].conv[0].weight.dtype)
            for block in self.cnn:
                x = block(x, training)
            return x
        return apply_cast(self.cnn, dtype,
                          self._inputs(occupancy, semantic, dtype)).float()

    @torch.no_grad()
    def update_running_stats(self, occupancy: torch.Tensor,
                             semantic: torch.Tensor) -> None:
        """Move each BatchNorm's running statistics toward the batch's, in
        one pass with the current weights: block i's batch statistics
        normalise its output, which feeds block i + 1 (JAX
        ``map_encoder_new_stats``)."""
        x = self._inputs(occupancy, semantic,
                         self.cnn[0].conv[0].weight.dtype)
        for block in self.cnn:
            bn = block.conv[1]
            pre = block.conv[0](x)
            var, mean = torch.var_mean(pre, dim=(0, 2, 3), unbiased=True)
            bn.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
            bn.running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var)
            x = F.avg_pool2d(F.relu(block.normalize(pre, True)), 2)

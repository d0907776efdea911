"""RedNet RGB-D semantic segmentation, inference only: the PyTorch
counterpart of ``ivlnce_tpu/models/rednet.py`` (reference
ivlnce_baselines/common/mapping_module/rednet.py).

Two ResNet-50 encoder streams (RGB and depth, fused by addition), a
``TransBasicBlock`` decoder with "agant" skip fusions, 13 classes. The
reference runs it frozen in eval mode, so the norms apply their running
statistics. Module names and widths are the reference's, so a converted
parameter tree (``models/convert.py``) loads as a ``state_dict``. The
layer counts are constructor arguments, so a reduced model can be built.
The convolutions, transposed convolutions and max-pool go to cuDNN.

Public functions keep the JAX package's NHWC layout."""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ivlnce_tpu_torch.models.nn import apply_cast
from ivlnce_tpu_torch.models.resnet import BNBottleneck
from ivlnce_tpu_torch.utils import profiling

RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)
DEPTH_MEAN = 0.213
DEPTH_STD = 0.285

LAYERS = (3, 4, 6, 3)
TRANS_LAYERS = (6, 4, 3, 3)  # deconv1..deconv4 block counts


class TransBasicBlock(nn.Module):
    """Reference TransBasicBlock (rednet.py:326-337). ``upsample`` is
    None, "deconv" (a stride-2 transposed conv on both branches) or
    "conv" (a 1x1 transition on the identity branch)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 upsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, inplanes, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(inplanes)
        if upsample == "deconv" and stride != 1:
            self.conv2 = nn.ConvTranspose2d(inplanes, planes, 3, stride, 1,
                                            output_padding=1, bias=False)
        else:
            self.conv2 = nn.Conv2d(inplanes, planes, 3, stride, 1,
                                   bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        if upsample == "deconv":
            branch = nn.ConvTranspose2d(inplanes, planes, 2, 2, 0, bias=False)
        elif upsample == "conv":
            branch = nn.Conv2d(inplanes, planes, 1, 1, 0, bias=False)
        self.upsample = (None if upsample is None
                         else nn.Sequential(branch, nn.BatchNorm2d(planes)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.upsample is None else self.upsample(x)
        return torch.relu(out + identity)


def _transpose_stage(inplanes: int, planes: int, blocks: int,
                     stride: int) -> nn.Sequential:
    """Reference _make_transpose (rednet.py:116-151): blocks - 1 identity
    blocks at ``inplanes``, then one up or transition block to
    ``planes``."""
    if stride != 1:
        kind = "deconv"
    elif inplanes != planes:
        kind = "conv"
    else:
        kind = None
    layers = [TransBasicBlock(inplanes, inplanes) for _ in range(blocks - 1)]
    layers.append(TransBasicBlock(inplanes, planes, stride, kind))
    return nn.Sequential(*layers)


def _agant(inplanes: int, planes: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(inplanes, planes, 1, 1, 0, bias=False),
        nn.BatchNorm2d(planes),
        nn.ReLU(inplace=True),
    )


class RedNet(nn.Module):
    def __init__(self, num_classes: int = 13,
                 layers: Sequence[int] = LAYERS,
                 trans_layers: Sequence[int] = TRANS_LAYERS):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv1_d = nn.Conv2d(1, 64, 7, 2, 3, bias=False)
        self.bn1_d = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        for suffix in ("", "_d"):
            inplanes = 64
            for si, (planes, blocks) in enumerate(
                zip((64, 128, 256, 512), layers)
            ):
                stride = 1 if si == 0 else 2
                stage = []
                for bi in range(blocks):
                    s = stride if bi == 0 else 1
                    ds = bi == 0 and (s != 1 or inplanes != planes * 4)
                    stage.append(BNBottleneck(inplanes, planes, s, ds))
                    inplanes = planes * 4
                setattr(self, f"layer{si + 1}{suffix}", nn.Sequential(*stage))
        inplanes = 512
        for di, (planes, blocks) in enumerate(
            zip((256, 128, 64, 64), trans_layers)
        ):
            setattr(self, f"deconv{di + 1}",
                    _transpose_stage(inplanes, planes, blocks, 2))
            inplanes = planes
        self.agant0 = _agant(64, 64)
        self.agant1 = _agant(64 * 4, 64)
        self.agant2 = _agant(128 * 4, 128)
        self.agant3 = _agant(256 * 4, 256)
        self.agant4 = _agant(512 * 4, 512)
        self.final_conv = _transpose_stage(64, 64, 3, 1)
        self.final_deconv_custom = nn.ConvTranspose2d(64, num_classes, 2, 2,
                                                      0, bias=True)

    def forward(self, rgb_norm: torch.Tensor,
                depth_norm: torch.Tensor) -> torch.Tensor:
        """Normalized NHWC rgb (B, H, W, 3) and depth (B, H, W, 1) ->
        class scores (B, H, W, C) (rednet.py:190-263)."""
        rgb = rgb_norm.permute(0, 3, 1, 2)
        depth = depth_norm.permute(0, 3, 1, 2)
        x = torch.relu(self.bn1(self.conv1(rgb)))
        d = torch.relu(self.bn1_d(self.conv1_d(depth)))
        fuse0 = x + d
        x = self.maxpool(fuse0)
        d = self.maxpool(d)
        fuses = [fuse0]
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            d = getattr(self, f"layer{i}_d")(d)
            x = x + d
            fuses.append(x)
        x = self.deconv1(self.agant4(fuses[4]))
        x = self.deconv2(x + self.agant3(fuses[3]))
        x = self.deconv3(x + self.agant2(fuses[2]))
        x = self.deconv4(x + self.agant1(fuses[1]))
        x = self.final_conv(x + self.agant0(fuses[0]))
        return self.final_deconv_custom(x).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize(...,
    "linear")`` along one axis: a triangle filter at half-pixel centres,
    widened by the scale when downsampling (antialiasing), each output's
    weights normalized to sum to one, and zero for samples outside the
    input."""
    f32 = np.float32
    # the scale and its inverse are Python floats there, rounded to
    # float32 only where they meet the float32 sample positions
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0), f32(1) - x / kernel_scale)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


@functools.lru_cache(maxsize=32)
def _resize_matrix(n_in: int, n_out: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """``_resize_weights`` on ``device`` in ``dtype``, uploaded at a
    shape's first call and only read after it."""
    with torch.inference_mode(False):
        return torch.from_numpy(_resize_weights(n_in, n_out)).to(device,
                                                                 dtype)


@functools.lru_cache(maxsize=8)
def _rgb_stats(device: torch.device,
               dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RGB mean and standard deviation on ``device`` in ``dtype``,
    uploaded at the first call and only read after it."""
    with torch.inference_mode(False):
        return (torch.tensor(RGB_MEAN, device=device, dtype=dtype),
                torch.tensor(RGB_STD, device=device, dtype=dtype))


def bilinear_resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """NHWC (B, H, W, C) -> (B, hw[0], hw[1], C) with the semantics of the
    JAX package's ``bilinear_resize`` (``jax.image.resize``, "linear"):
    half-pixel centres, antialiased when downsampling, in ``x``'s dtype
    (the weights cast to it). An axis whose size does not change is left
    as it is."""
    for axis, n_out in ((1, hw[0]), (2, hw[1])):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        w = _resize_matrix(n_in, n_out, x.device, x.dtype)
        x = torch.movedim(
            torch.tensordot(x, w, dims=([axis], [0])), -1, axis
        )
    return x


def normalize_inputs(rgb_uint8: torch.Tensor, depth_normalized: torch.Tensor,
                     dtype: Optional[torch.dtype] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RedNet's inputs (reference mapper.py:715-736): RGB /255, resized to
    the depth size, ImageNet-normalized; depth (B, H, W) or (B, H, W, 1)
    normalized with mean .213 and std .285. Both NHWC, in ``dtype``
    (float32 when None) throughout, as JAX rednet.py:249-258 computes
    them."""
    dtype = dtype or torch.float32
    hw = depth_normalized.shape[1:3]
    rgb = rgb_uint8.to(dtype) / 255.0
    rgb = bilinear_resize(rgb, hw)
    mean, std = _rgb_stats(rgb.device, dtype)
    rgb = (rgb - mean) / std
    if depth_normalized.dim() == 3:
        depth_normalized = depth_normalized[..., None]
    depth = (depth_normalized.to(dtype) - DEPTH_MEAN) / DEPTH_STD
    return rgb, depth


def predict_semantics(model: RedNet, rgb_uint8: torch.Tensor,
                      depth_normalized: torch.Tensor,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """RedNet labels at the depth resolution (reference mapper.py:782-800):
    the argmax of the scores of ``normalize_inputs``, (B, H, W) uint8.
    ``dtype`` (``TPU.compute_dtype``) runs the inputs and the model, on a
    cast copy of its weights, in that dtype (JAX rednet.py:236-260).
    Spans ``rednet_inputs``, ``rednet`` and ``rednet_labels`` cover the
    three phases; the counter ``rednet_frames`` adds the frames labelled."""
    with profiling.span("rednet_inputs"):
        inputs = normalize_inputs(rgb_uint8, depth_normalized, dtype)
    with profiling.span("rednet"):
        scores = (model(*inputs) if dtype is None
                  else apply_cast(model, dtype, *inputs))
    with profiling.span("rednet_labels"):
        labels = torch.argmax(scores, dim=-1).to(torch.uint8)
    profiling.count("rednet_frames", labels.shape[0])
    return labels

"""The plain RedNet, frozen with the benchmark: the RGB-D semantic
segmentation network of Jiang et al. 2018 ("RedNet: Residual
Encoder-Decoder Network for indoor RGB-D Semantic Segmentation",
arXiv:1806.01054) as IVLN-CE (arXiv:2210.03087) runs it to label its
semantic map (the reference's ``mapping_module/rednet.py`` and
``mapper.py:715-800``), written as plain float32 functions of a weights
dict named as the port's ``RedNet.state_dict()`` names it.

- Two ResNet-50 encoder streams of torchvision bottlenecks (the stride on
  the 3x3 convolution), one for RGB and one for depth, each a 7x7 stem
  with a frozen BatchNorm and ReLU, a 3x3 max-pool and four stages of
  ``layers`` blocks; the depth stream is added into the RGB stream after
  the stem and after each stage, and the RGB stream goes on from the sum.
- A decoder of four transposed-convolution stages of ``trans_layers``
  residual blocks (the last block of each doubles the side with a 3x3
  stride-2 transposed convolution, and a 2x2 one with a BatchNorm on the
  identity), to 256, 128, 64 and 64 channels; before each stage after
  the first, and before the final stage, the sum of the matching stem or
  stage output through a 1x1 "agant" convolution, BatchNorm and ReLU.
- A final stage of three residual blocks at 64 channels, and a 2x2
  stride-2 transposed convolution with a bias to the classes.

Every norm applies its running statistics (eps 1e-5), as the reference
evaluates RedNet. Departures from the published description:

- inference only: the side outputs that train the decoder with deep
  supervision (``out2_conv`` to ``out5_conv``) are not computed, as the
  reference's eval forward computes none;
- the input preparation is IVLN-CE's (RGB / 255 resized to the depth's
  size with ``F.interpolate`` bilinear, ``align_corners=False``, then the
  ImageNet mean and standard deviation; depth as ``(d - 0.213) / 0.285``),
  not the paper's SUN RGB-D one;
- the head is IVLN-CE's ``final_deconv_custom`` to 13 MP3D classes, not
  the paper's 37 SUN RGB-D classes.

It imports neither JAX, the JAX package nor any module of the port. The
layer counts are arguments, so a smaller model can be built."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

LAYERS = (3, 4, 6, 3)
TRANS_LAYERS = (6, 4, 3, 3)
PLANES = (64, 128, 256, 512)  # the encoder stages' bottleneck widths
TRANS_PLANES = (256, 128, 64, 64)  # the decoder stages' output widths
FINAL_BLOCKS = 3
EPS = 1e-5

RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)
DEPTH_MEAN = 0.213
DEPTH_STD = 0.285

Weights = Dict[str, torch.Tensor]


def prepare(rgb_uint8: torch.Tensor, depth: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RedNet's inputs, NCHW float32: RGB (B, h, w, 3) uint8 over 255,
    resized bilinearly to the depth's (H, W), ImageNet-normalised; depth
    (B, H, W) in [0, 1] (the decoded wire depth) as (d - 0.213) / 0.285,
    (B, 1, H, W)."""
    hw = tuple(depth.shape[-2:])
    rgb = rgb_uint8.permute(0, 3, 1, 2).float() / 255.0
    if tuple(rgb.shape[-2:]) != hw:
        rgb = F.interpolate(rgb, size=hw, mode="bilinear",
                            align_corners=False)
    mean = torch.tensor(RGB_MEAN, device=rgb.device).view(1, 3, 1, 1)
    std = torch.tensor(RGB_STD, device=rgb.device).view(1, 3, 1, 1)
    rgb = (rgb - mean) / std
    d = (depth.float()[:, None] - DEPTH_MEAN) / DEPTH_STD
    return rgb, d


def _bn(w: Weights, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, w[f"{name}.running_mean"], w[f"{name}.running_var"],
                        w[f"{name}.weight"], w[f"{name}.bias"],
                        training=False, eps=EPS)


def _conv(w: Weights, name: str, x: torch.Tensor, stride: int = 1,
          padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, w[f"{name}.weight"], w.get(f"{name}.bias"), stride,
                    padding)


def _bottleneck(w: Weights, p: str, x: torch.Tensor, stride: int,
                downsample: bool) -> torch.Tensor:
    out = F.relu(_bn(w, f"{p}.bn1", _conv(w, f"{p}.conv1", x)))
    out = F.relu(_bn(w, f"{p}.bn2", _conv(w, f"{p}.conv2", out, stride, 1)))
    out = _bn(w, f"{p}.bn3", _conv(w, f"{p}.conv3", out))
    if downsample:
        x = _bn(w, f"{p}.downsample.1",
                _conv(w, f"{p}.downsample.0", x, stride))
    return F.relu(out + x)


def _stage(w: Weights, p: str, x: torch.Tensor, blocks: int,
           stride: int) -> torch.Tensor:
    """An encoder stage: the first block strides and projects its
    identity, the rest keep the shape."""
    for b in range(blocks):
        x = _bottleneck(w, f"{p}.{b}", x, stride if b == 0 else 1, b == 0)
    return x


def _trans_block(w: Weights, p: str, x: torch.Tensor, stride: int,
                 kind) -> torch.Tensor:
    """A decoder block; ``kind`` None keeps the shape, "conv" changes the
    width with a 1x1 convolution on the identity, "deconv" doubles the
    side on both branches."""
    out = F.relu(_bn(w, f"{p}.bn1", _conv(w, f"{p}.conv1", x, 1, 1)))
    if kind == "deconv":
        out = F.conv_transpose2d(out, w[f"{p}.conv2.weight"], None, stride,
                                 1, output_padding=1)
        x = _bn(w, f"{p}.upsample.1", F.conv_transpose2d(
            x, w[f"{p}.upsample.0.weight"], None, 2, 0))
    else:
        out = _conv(w, f"{p}.conv2", out, stride, 1)
        if kind == "conv":
            x = _bn(w, f"{p}.upsample.1", _conv(w, f"{p}.upsample.0", x))
    out = _bn(w, f"{p}.bn2", out)
    return F.relu(out + x)


def _trans_stage(w: Weights, p: str, x: torch.Tensor, blocks: int,
                 inplanes: int, planes: int, stride: int) -> torch.Tensor:
    """``blocks - 1`` blocks at ``inplanes``, then one that strides or
    changes the width to ``planes``."""
    for b in range(blocks - 1):
        x = _trans_block(w, f"{p}.{b}", x, 1, None)
    kind = ("deconv" if stride != 1
            else "conv" if inplanes != planes else None)
    return _trans_block(w, f"{p}.{blocks - 1}", x, stride, kind)


def _agant(w: Weights, p: str, x: torch.Tensor) -> torch.Tensor:
    return F.relu(_bn(w, f"{p}.1", _conv(w, f"{p}.0", x)))


def forward(w: Weights, rgb: torch.Tensor, depth: torch.Tensor,
            layers: Sequence[int] = LAYERS,
            trans_layers: Sequence[int] = TRANS_LAYERS) -> torch.Tensor:
    """Prepared NCHW RGB (B, 3, H, W) and depth (B, 1, H, W) -> class
    scores (B, C, H, W)."""
    x = F.relu(_bn(w, "bn1", _conv(w, "conv1", rgb, 2, 3)))
    d = F.relu(_bn(w, "bn1_d", _conv(w, "conv1_d", depth, 2, 3)))
    fuses = [x + d]
    x = F.max_pool2d(fuses[0], 3, 2, 1)
    d = F.max_pool2d(d, 3, 2, 1)
    for i, blocks in enumerate(layers):
        stride = 1 if i == 0 else 2
        x = _stage(w, f"layer{i + 1}", x, blocks, stride)
        d = _stage(w, f"layer{i + 1}_d", d, blocks, stride)
        x = x + d
        fuses.append(x)
    x = _agant(w, "agant4", fuses[4])
    inplanes = PLANES[-1]
    for i, (planes, blocks) in enumerate(zip(TRANS_PLANES, trans_layers)):
        if i:
            x = x + _agant(w, f"agant{4 - i}", fuses[4 - i])
        x = _trans_stage(w, f"deconv{i + 1}", x, blocks, inplanes, planes, 2)
        inplanes = planes
    x = x + _agant(w, "agant0", fuses[0])
    x = _trans_stage(w, "final_conv", x, FINAL_BLOCKS, inplanes, inplanes, 1)
    return F.conv_transpose2d(x, w["final_deconv_custom.weight"],
                              w["final_deconv_custom.bias"], 2, 0)


@torch.no_grad()
def scores(w: Weights, rgb_uint8: torch.Tensor, depth: torch.Tensor,
           layers: Sequence[int] = LAYERS,
           trans_layers: Sequence[int] = TRANS_LAYERS,
           block: int = 16) -> torch.Tensor:
    """Class scores (B, C, H, W) of wire frames: RGB (B, h, w, 3) uint8
    and depth (B, H, W) in [0, 1], ``block`` frames at a time, in float32
    with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.cat([
        forward(w, *prepare(rgb_uint8[i:i + block], depth[i:i + block]),
                layers, trans_layers)
        for i in range(0, len(depth), block)])

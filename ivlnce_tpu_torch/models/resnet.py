"""The DDPPO GroupNorm ResNet-50 depth encoder and the torchvision
BatchNorm trunks of the RGB encoder: the PyTorch counterpart of
``ivlnce_tpu/models/resnet.py`` (habitat-lab v0.1.7 structure, reference
resnet_encoders.py:17-229). Module names follow the reference
checkpoints."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

RESNET50_LAYERS = (3, 4, 6, 3)
RESNET18_LAYERS = (2, 2, 2, 2)


class GNBottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, ngroups: int,
                 stride: int, downsample: bool):
        super().__init__()
        self.convs = nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, bias=False),
            nn.GroupNorm(ngroups, planes),
            nn.ReLU(True),
            nn.Conv2d(planes, planes, 3, stride, 1, bias=False),
            nn.GroupNorm(ngroups, planes),
            nn.ReLU(True),
            nn.Conv2d(planes, planes * 4, 1, bias=False),
            nn.GroupNorm(ngroups, planes * 4),
        )
        self.downsample = (
            nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                nn.GroupNorm(ngroups, planes * 4),
            )
            if downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.convs(x) + identity)


class GNResNet(nn.Module):
    def __init__(self, in_channels: int, base_planes: int = 32,
                 ngroups: int = 16):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.Conv2d(in_channels, base_planes, 7, 2, 3, bias=False),
            nn.GroupNorm(ngroups, base_planes),
            nn.ReLU(True),
        )
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = base_planes
        for si, blocks in enumerate(RESNET50_LAYERS):
            planes = base_planes * 2 ** si
            stride = 1 if si == 0 else 2
            stage = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                ds = bi == 0 and (s != 1 or inplanes != planes * 4)
                stage.append(GNBottleneck(inplanes, planes, ngroups, s, ds))
                inplanes = planes * 4
            setattr(self, f"layer{si + 1}", nn.Sequential(*stage))
        self.final_channels = inplanes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.conv1(x))
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x


class ResNetEncoder(nn.Module):
    """avg_pool2d(depth, 2) -> backbone -> 3x3 compression conv."""

    def __init__(self, spatial_size: int, in_channels: int = 1,
                 base_planes: int = 32, ngroups: int = 16):
        super().__init__()
        self.backbone = GNResNet(in_channels, base_planes, ngroups)
        final_spatial = int(spatial_size * (1.0 / 32))
        num_compression = int(round(2048 / (final_spatial ** 2)))
        self.compression = nn.Sequential(
            nn.Conv2d(self.backbone.final_channels, num_compression, 3,
                      padding=1, bias=False),
            nn.GroupNorm(1, num_compression),
            nn.ReLU(True),
        )
        self.output_shape = (num_compression, final_spatial, final_spatial)

    def forward(self, depth_nchw: torch.Tensor) -> torch.Tensor:
        x = nn.functional.avg_pool2d(depth_nchw, 2)
        return self.compression(self.backbone(x))


class VlnResnetDepthEncoder(nn.Module):
    """ResNetEncoder features + a learned per-cell spatial embedding on
    the channels (spatial_output=True, resnet_encoders.py:74-83)."""

    def __init__(self, spatial_size: int, spatial_embedding_dim: int = 64):
        super().__init__()
        self.visual_encoder = ResNetEncoder(spatial_size)
        c, h, w = self.visual_encoder.output_shape
        self.spatial_embeddings = nn.Embedding(h * w, spatial_embedding_dim)
        self.output_shape: Tuple[int, int, int] = (
            c + spatial_embedding_dim, h, w
        )

    def forward(self, depth_nhwc: torch.Tensor) -> torch.Tensor:
        """depth (B, H, W, 1) in [0, 1] -> (B, C + 64, h, w)."""
        x = self.visual_encoder(depth_nhwc.permute(0, 3, 1, 2))
        b, _, h, w = x.shape
        emb = self.spatial_embeddings.weight  # (h*w, D)
        spatial = emb.t().reshape(1, -1, h, w).expand(b, -1, h, w)
        return torch.cat([x, spatial], dim=1)


class BNBottleneck(nn.Module):
    """torchvision's BatchNorm ResNet-50 bottleneck, as RedNet's encoder
    streams use it (``ivlnce_tpu/models/resnet.py:190-220``). Run in eval
    mode: the norms apply their running statistics."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int,
                 downsample: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (
            nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                nn.BatchNorm2d(planes * 4),
            )
            if downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class BNBasicBlock(nn.Module):
    """torchvision's BatchNorm ResNet-18 basic block: two 3x3 convolutions,
    expansion 1 (``ivlnce_tpu/models/resnet.py:263-294``)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int,
                 downsample: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = (
            nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes),
            )
            if downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


def bn_resnet_trunk(block, layers) -> nn.Sequential:
    """conv1 .. layer4 of a torchvision ResNet as the reference's
    ``Sequential(*resnet.children())`` numbers them: 0 conv1, 1 bn1,
    2 relu, 3 maxpool, 4-7 layer1-layer4 (no pooling, no fc)."""
    mods = [nn.Conv2d(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64),
            nn.ReLU(True), nn.MaxPool2d(3, 2, 1)]
    inplanes = 64
    for si, blocks in enumerate(layers):
        planes = 64 * 2 ** si
        stride = 1 if si == 0 else 2
        stage = []
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            out = planes * block.expansion
            stage.append(block(inplanes, planes, s,
                               bi == 0 and (s != 1 or inplanes != out)))
            inplanes = out
        mods.append(nn.Sequential(*stage))
    trunk = nn.Sequential(*mods)
    trunk.final_channels = inplanes
    return trunk


class TorchVisionResNetSpatial(nn.Module):
    """The RGB encoder ``TorchVisionResNet50`` / ``TorchVisionResNet18``
    with spatial_output=True (resnet_encoders.py:118-229;
    ``ivlnce_tpu/models/resnet.py:345-413``): uint8 NHWC scaled by 1/255
    only, the frozen trunk with its running statistics, an adaptive
    average pool to 4x4 and a learned 16-cell spatial embedding on the
    channels: (B, 2048 + 64, 4, 4) or (B, 512 + 64, 4, 4)."""

    def __init__(self, cnn_type: str, spatial_embedding_dim: int = 64):
        super().__init__()
        if cnn_type == "TorchVisionResNet50":
            self.cnn = bn_resnet_trunk(BNBottleneck, RESNET50_LAYERS)
        elif cnn_type == "TorchVisionResNet18":
            self.cnn = bn_resnet_trunk(BNBasicBlock, RESNET18_LAYERS)
        else:
            raise ValueError(f"unknown RGB encoder {cnn_type}")
        self.spatial_embeddings = nn.Embedding(16, spatial_embedding_dim)
        self.output_shape: Tuple[int, int, int] = (
            self.cnn.final_channels + spatial_embedding_dim, 4, 4
        )

    def train(self, mode: bool = True):
        """The trunk stays in eval mode: both users freeze it."""
        super().train(mode)
        self.cnn.eval()
        return self

    def forward(self, rgb_nhwc: torch.Tensor) -> torch.Tensor:
        x = rgb_nhwc.permute(0, 3, 1, 2).float() / 255.0
        x = nn.functional.adaptive_avg_pool2d(self.cnn(x), 4)
        b = x.shape[0]
        emb = self.spatial_embeddings.weight  # (16, D)
        spatial = emb.t().reshape(1, -1, 4, 4).expand(b, -1, 4, 4)
        return torch.cat([x, spatial], dim=1)

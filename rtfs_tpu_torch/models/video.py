"""Frozen lip-embedding backbone: FRCNNVideoModel with the ResNet-18 trunk.

Counterpart of ``rtfs_tpu/models/video.py`` (``ChannelPReLU``, ``_ConvBN``,
``BasicBlock``, ``ResNetTrunk``, ``FRCNNVideoModel``), forward in eval
mode only: during AV training the backbone is frozen (reference
``frcnn_videomodel.py:103-115``), so its BatchNorms always normalise with
their running statistics and nothing in it takes a gradient.

Boundary layouts are the JAX package's: mouths (B, T, H, W) in, embeddings
(B, T, 512) out. Inside, maps are channels-first. Module and parameter
names are the reference PyTorch checkpoint's (``frontend3D.{0,1,2}``,
``trunk.layer{1..4}.{0,1}.{conv1,bn1,relu1,conv2,bn2,downsample,relu2}``),
which ``rtfs_tpu/utils/torch_import.py:convert_frcnn_video`` reads, so a
reference ``.pth.tar`` loads with ``load_state_dict``. The ShuffleNetV2
trunk and the autoencoder backbone are not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import layers as L


def _msra_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Reference ResNet init: normal(0, sqrt(2 / (k*k*C_out)))
    (``resnet.py:91-94``)."""
    n = math.prod(w.shape[2:]) * w.shape[0]
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / n), generator=generator)


def _act(relu_type: str, channels: int) -> nn.Module:
    return nn.PReLU(channels) if relu_type == "prelu" else nn.ReLU()


class _ConvBN(nn.Sequential):
    """conv (no bias) + BatchNorm: the ``downsample`` pair, keys ``0``/``1``."""

    def __init__(self, in_chan, out_chan, kernel, stride=1):
        super().__init__(nn.Conv2d(in_chan, out_chan, kernel, stride=stride,
                                   bias=False),
                         L.BatchNorm(out_chan))


class BasicBlock(nn.Module):
    """ResNet BasicBlock with PReLU (reference ``resnet.py:24-65``)."""

    def __init__(self, inplanes, planes, stride=1, has_downsample=False,
                 relu_type="prelu"):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = L.BatchNorm(planes)
        self.relu1 = _act(relu_type, planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = L.BatchNorm(planes)
        self.downsample = (_ConvBN(inplanes, planes, 1, stride)
                           if has_downsample else None)
        self.relu2 = _act(relu_type, planes)

    def forward(self, x):
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu2(out + residual)


class ResNetTrunk(nn.Module):
    """ResNet-18 trunk: layers [2, 2, 2, 2], then the spatial mean
    (``AdaptiveAvgPool2d(1)``) -> (N, 512) (reference ``resnet.py:68-130``)."""

    def __init__(self, relu_type="prelu"):
        super().__init__()
        inplanes = 64
        for n, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 2),
                                              (512, 2)), start=1):
            blocks = []
            for i in range(2):
                s = stride if i == 0 else 1
                ds = i == 0 and (s != 1 or inplanes != planes)
                blocks.append(BasicBlock(inplanes, planes, s, ds, relu_type))
                inplanes = planes
            setattr(self, f"layer{n}", nn.Sequential(*blocks))

    def forward(self, x):
        for n in range(1, 5):
            x = getattr(self, f"layer{n}")(x)
        return x.mean(dim=(2, 3))


class FRCNNVideoModel(nn.Module):
    """Conv3d (5, 7, 7) / (1, 2, 2) + BN + PReLU + MaxPool3d (1, 3, 3) /
    (1, 2, 2), then the ResNet-18 trunk per frame (reference
    ``frcnn_videomodel.py:16-100``). ``forward((B, T, H, W)) -> (B, T, 512)``.
    """

    def __init__(self, backbone_type="resnet", relu_type="prelu"):
        super().__init__()
        if backbone_type != "resnet":
            raise NotImplementedError(
                f"video backbone {backbone_type!r} is not ported (resnet only)")
        self.frontend3D = nn.Sequential(
            nn.Conv3d(1, 64, (5, 7, 7), stride=(1, 2, 2), padding=(2, 3, 3),
                      bias=False),
            L.BatchNorm(64),
            _act(relu_type, 64),
        )
        self.trunk = ResNetTrunk(relu_type)

    def init_weights(self, generator: torch.Generator) -> None:
        """Convs from ``generator`` (MSRA normal); BatchNorm and PReLU keep
        their constant initial values."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                _msra_(m.weight, generator)

    def forward(self, x):
        b, t = x.shape[:2]
        x = self.frontend3D(x[:, None])  # (B, 64, T, H', W')
        x = F.max_pool3d(x, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))
        c = x.shape[1]
        x = x.transpose(1, 2).reshape(b * t, c, *x.shape[3:])  # frames
        return self.trunk(x).reshape(b, t, -1)

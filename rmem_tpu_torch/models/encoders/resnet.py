"""ResNet-50 backbone at output stride 16 with frozen BN: the stem and
stages 1-3 (stage 4 is not run; the 16x feature is emitted twice).

Counterpart of `rmem_tpu/models/encoders/resnet.py`. The stem (conv7x7/s2,
BN, relu, maxpool) is one call of the stem kernel (kernels/stem.py), through
its differentiable wrapper (K7) when the module trains.
Feature maps are NCHW; on the card they are channels-last in memory, as the
stem kernel writes NHWC.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from rmem_tpu_torch.kernels import stem as stem_kernel
from rmem_tpu_torch.ops.layers import FoldedBN, conv


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4) with a projection shortcut."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 1, bias=False)
        self.bn1 = FoldedBN(planes)
        self.conv2 = conv(planes, planes, 3, stride=stride, bias=False)
        self.bn2 = FoldedBN(planes)
        self.conv3 = conv(planes, planes * 4, 1, bias=False)
        self.bn3 = FoldedBN(planes * 4)
        self.has_downsample = has_downsample
        if has_downsample:
            self.downsample_conv = conv(inplanes, planes * 4, 1,
                                        stride=stride, bias=False)
            self.downsample_bn = FoldedBN(planes * 4)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = (self.downsample_bn(self.downsample_conv(x))
                    if self.has_downsample else x)
        return torch.relu(out + residual)


class ResNet(nn.Module):
    """Returns the pyramid [4x, 8x, 16x, 16x] for an NHWC image."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FoldedBN(64)
        self.stages = []
        inplanes = 64
        for stage, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256), layers[:3], (1, 2, 2)), start=1):
            names = []
            for i in range(blocks):
                name = f"layer{stage}_{i}"
                setattr(self, name, Bottleneck(
                    inplanes, planes, stride=stride if i == 0 else 1,
                    has_downsample=(i == 0)))
                inplanes = planes * 4
                names.append(name)
            self.stages.append(names)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        stem = (stem_kernel.stem_trainable if self.training
                else stem_kernel.stem)
        x = stem(x, self.conv1.weight, self.bn1.scale,
                 self.bn1.bias).permute(0, 3, 1, 2)
        xs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            xs.append(x)
        xs.append(x)
        return tuple(xs)


def ResNet50() -> ResNet:
    return ResNet(layers=(3, 4, 6, 3))

"""ResNeSt-50/101 backbone (split attention) at output stride 16 with frozen
BN: the deep 3-conv stem, stages 1-3 (the 16x feature emitted twice).

Counterpart of `rmem_tpu/models/encoders/resnest.py`: radix-2 split
attention in each bottleneck's 3x3 conv with its radix softmax in f32, the
3x3 average pool `avd` after it in strided (and stage-first) blocks, and
the average-pool shortcut. Module names follow the flax paths (`stem0`,
`stem0_bn`, `stem1`, `stem1_bn`, `stem2`, `bn1`, `layer2_0.conv2.fc1`).
NCHW feature maps.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rmem_tpu_torch.ops.layers import FoldedBN, conv, max_pool_3x3_s2


def avg_down(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The shortcut's pool: flax's avg_pool over stride x stride windows at
    that stride, "SAME" padding, padded zeros not counted. For a window as
    wide as its stride SAME pads only past the end, so this is PyTorch's
    ceil-mode pool without the padding in the count."""
    return F.avg_pool2d(x, stride, stride, ceil_mode=True,
                        count_include_pad=False)


class SplAtConv2d(nn.Module):
    """Grouped radix conv -> pooled gate -> softmax over the radix ->
    weighted sum of the splits."""

    def __init__(self, inp: int, channels: int, radix: int = 2,
                 cardinality: int = 1, dilation: int = 1):
        super().__init__()
        self.radix, self.cardinality, self.channels = (radix, cardinality,
                                                       channels)
        inter = max(channels * radix // 4, 32)
        self.conv = conv(inp, channels * radix, 3, dilation=dilation,
                         groups=cardinality * radix, bias=False)
        self.bn0 = FoldedBN(channels * radix)
        self.fc1 = conv(channels, inter, 1, groups=cardinality)
        self.bn1 = FoldedBN(inter)
        self.fc2 = conv(inter, channels * radix, 1, groups=cardinality)

    def forward(self, x):
        r, card, ch = self.radix, self.cardinality, self.channels
        y = torch.relu(self.bn0(self.conv(x)))
        splits = torch.split(y, ch, dim=1)
        gap = sum(splits).mean(dim=(2, 3), keepdim=True)
        gap = torch.relu(self.bn1(self.fc1(gap)))
        atten = self.fc2(gap)                           # [B, ch*r, 1, 1]
        b = atten.shape[0]
        a = torch.softmax(atten.reshape(b, card, r, ch // card).float(),
                          dim=2).to(y.dtype)
        return sum(a[:, :, i].reshape(b, ch, 1, 1) * sp
                   for i, sp in enumerate(splits))


class ResNeStBottleneck(nn.Module):
    """1x1 -> split-attention 3x3 (+ the avd pool) -> 1x1 (x4), with the
    average-pool projection shortcut."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 is_first: bool = False, has_downsample: bool = False,
                 radix: int = 2):
        super().__init__()
        gw = planes          # group width at cardinality 1, base width 64
        self.stride = stride
        self.avd = stride > 1 or is_first
        self.conv1 = conv(inplanes, gw, 1, bias=False)
        self.bn1 = FoldedBN(gw)
        self.conv2 = SplAtConv2d(gw, gw, radix=radix)
        self.conv3 = conv(gw, planes * 4, 1, bias=False)
        self.bn3 = FoldedBN(planes * 4)
        self.has_downsample = has_downsample
        if has_downsample:
            self.downsample_conv = conv(inplanes, planes * 4, 1, bias=False)
            self.downsample_bn = FoldedBN(planes * 4)

    def forward(self, x):
        out = self.conv2(torch.relu(self.bn1(self.conv1(x))))
        if self.avd:
            out = F.avg_pool2d(out, 3, self.stride, 1)
        out = self.bn3(self.conv3(out))
        residual = x
        if self.has_downsample:
            if self.stride > 1:
                residual = avg_down(residual, self.stride)
            residual = self.downsample_bn(self.downsample_conv(residual))
        return torch.relu(out + residual)


class ResNeSt(nn.Module):
    """Returns the pyramid [4x, 8x, 16x, 16x] for an NHWC image."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6),
                 stem_width: int = 32):
        super().__init__()
        sw = stem_width
        self.stem0 = conv(3, sw, 3, stride=2, bias=False)
        self.stem0_bn = FoldedBN(sw)
        self.stem1 = conv(sw, sw, 3, bias=False)
        self.stem1_bn = FoldedBN(sw)
        self.stem2 = conv(sw, sw * 2, 3, bias=False)
        self.bn1 = FoldedBN(sw * 2)
        self.stages = []
        inplanes = sw * 2
        for stage, (planes, blocks, stride, is_first) in enumerate(
                zip((64, 128, 256), layers, (1, 2, 2), (False, True, True)),
                start=1):
            names = []
            for i in range(blocks):
                name = f"layer{stage}_{i}"
                setattr(self, name, ResNeStBottleneck(
                    inplanes, planes, stride=stride if i == 0 else 1,
                    is_first=is_first and i == 0, has_downsample=(i == 0)))
                inplanes = planes * 4
                names.append(name)
            self.stages.append(names)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = x.permute(0, 3, 1, 2).to(self.stem0.weight.dtype)
        x = torch.relu(self.stem0_bn(self.stem0(x)))
        x = torch.relu(self.stem1_bn(self.stem1(x)))
        x = max_pool_3x3_s2(torch.relu(self.bn1(self.stem2(x))))
        xs = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            xs.append(x)
        xs.append(x)
        return tuple(xs)


def ResNeSt50() -> ResNeSt:
    return ResNeSt(layers=(3, 4, 6), stem_width=32)


def ResNeSt101() -> ResNeSt:
    return ResNeSt(layers=(3, 4, 23), stem_width=64)

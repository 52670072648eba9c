"""MobileNetV2 backbone at output stride 16 with frozen BN: the stages end
at 4x (24 channels), 8x (32) and 16x (96), and the last stages run dilated
at 16x into the 1x1 head (1280).

Counterpart of `rmem_tpu/models/encoders/mobilenet.py`. Module names follow
the flax paths (`block3.pw.conv`, `block3.dw.bn`, `block3.pw_linear`,
`block3.bn_out`). The depthwise convs are grouped `conv2d` calls (cuDNN).
Feature maps are NCHW (channels-last in memory: the image arrives NHWC).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from rmem_tpu_torch.ops.layers import FoldedBN, conv


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x).clamp_max(6.0)


class ConvBNReLU6(nn.Module):
    def __init__(self, inp: int, features: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = conv(inp, features, kernel, stride=stride,
                         dilation=dilation, bias=False, groups=groups)
        self.bn = FoldedBN(features)

    def forward(self, x):
        return relu6(self.bn(self.conv(x)))


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int, dilation: int,
                 expand: int):
        super().__init__()
        hidden = int(round(inp * expand))
        self.expand = expand != 1
        if self.expand:
            self.pw = ConvBNReLU6(inp, hidden, kernel=1)
        self.dw = ConvBNReLU6(hidden, hidden, kernel=3, stride=stride,
                              dilation=dilation, groups=hidden)
        self.pw_linear = conv(hidden, oup, 1, bias=False)
        self.bn_out = FoldedBN(oup)
        self.residual = stride == 1 and inp == oup

    def forward(self, x):
        out = self.pw(x) if self.expand else x
        out = self.bn_out(self.pw_linear(self.dw(out)))
        return out + x if self.residual else out


# (expand t, channels c, repeats n, stride s)
_SETTING = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]
_TAPS = (4, 7, 14)  # block counts that end the 4x / 8x / 16x stages


class MobileNetV2(nn.Module):
    """Returns the pyramid [4x, 8x, 16x, 16x head] for an NHWC image."""

    def __init__(self, output_stride: int = 16, width_mult: float = 1.0):
        super().__init__()
        input_channel = _make_divisible(32 * width_mult)
        last_channel = _make_divisible(1280 * max(1.0, width_mult))
        self.stem = ConvBNReLU6(3, input_channel, kernel=3, stride=2)
        idx, inp = 1, input_channel
        current_stride, rate = 2, 1
        self.taps = []
        for t, c, n, s in _SETTING:
            if current_stride == output_stride:
                stride, dilation = 1, rate
                rate *= s
            else:
                stride, dilation = s, 1
                current_stride *= s
            oup = _make_divisible(c * width_mult)
            for i in range(n):
                setattr(self, f"block{idx}", InvertedResidual(
                    inp, oup, stride if i == 0 else 1,
                    dilation if i == 0 else rate, t))
                inp = oup
                idx += 1
                if idx in _TAPS:
                    self.taps.append(idx - 1)
        self.num_blocks = idx - 1
        self.head = ConvBNReLU6(inp, last_channel, kernel=1)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = self.stem(x.permute(0, 3, 1, 2).to(self.stem.conv.weight.dtype))
        xs = []
        for idx in range(1, self.num_blocks + 1):
            x = getattr(self, f"block{idx}")(x)
            if idx in self.taps:
                xs.append(x)
        xs.append(self.head(x))
        return tuple(xs)

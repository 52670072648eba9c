"""MobileNetV3-Large backbone at output stride 16 with frozen BN: the
pyramid 24 @ 4x, 40 @ 8x, 112 @ 16x and the final 1x1 expansion, 960 @ 16x.

Counterpart of `rmem_tpu/models/encoders/mobilenetv3.py`: h-sigmoid
clip(x + 3, 0, 6) / 6, h-swish x * h-sigmoid(x), squeeze-excitation on the
blocks the table marks (`se.fc1`, `se.fc2` as Linear layers). Module names
follow the flax paths (`stem`, `stem_bn`, `block4.pw`, `block4.pw_bn`,
`block4.dw`, `block4.dw_bn`, `block4.se`, `block4.pw_linear`,
`block4.out_bn`, `head`, `head_bn`). NCHW feature maps.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from rmem_tpu_torch.models.encoders.mobilenet import _make_divisible
from rmem_tpu_torch.ops.layers import FoldedBN, conv


def h_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def h_swish(x: torch.Tensor) -> torch.Tensor:
    return x * h_sigmoid(x)


class SELayer(nn.Module):
    def __init__(self, channel: int):
        super().__init__()
        hidden = _make_divisible(channel // 4)
        self.fc1 = nn.Linear(channel, hidden)
        self.fc2 = nn.Linear(hidden, channel)

    def forward(self, x):
        y = x.mean(dim=(2, 3))
        y = h_sigmoid(self.fc2(torch.relu(self.fc1(y))))
        return x * y[:, :, None, None]


class InvertedResidualV3(nn.Module):
    def __init__(self, inp: int, hidden: int, oup: int, kernel: int,
                 stride: int, use_se: bool, use_hs: bool, dilation: int = 1):
        super().__init__()
        self.act = h_swish if use_hs else torch.relu
        self.expand = inp != hidden
        if self.expand:
            self.pw = conv(inp, hidden, 1, bias=False)
            self.pw_bn = FoldedBN(hidden)
        self.dw = conv(hidden, hidden, kernel, stride=stride,
                       dilation=dilation, groups=hidden, bias=False)
        self.dw_bn = FoldedBN(hidden)
        self.use_se = use_se
        if use_se:
            self.se = SELayer(hidden)
        self.pw_linear = conv(hidden, oup, 1, bias=False)
        self.out_bn = FoldedBN(oup)
        self.residual = stride == 1 and inp == oup

    def forward(self, x):
        out = self.act(self.pw_bn(self.pw(x))) if self.expand else x
        out = self.dw_bn(self.dw(out))
        if self.use_se:
            out = self.se(out)
        out = self.out_bn(self.pw_linear(self.act(out)))
        return out + x if self.residual else out


# (kernel k, expand t, channels c, SE, HS, stride s)
_CFGS = [
    (3, 1.0, 16, 0, 0, 1),
    (3, 4.0, 24, 0, 0, 2),
    (3, 3.0, 24, 0, 0, 1),
    (5, 3.0, 40, 1, 0, 2),
    (5, 3.0, 40, 1, 0, 1),
    (5, 3.0, 40, 1, 0, 1),
    (3, 6.0, 80, 0, 1, 2),
    (3, 2.5, 80, 0, 1, 1),
    (3, 2.3, 80, 0, 1, 1),
    (3, 2.3, 80, 0, 1, 1),
    (3, 6.0, 112, 1, 1, 1),
    (3, 6.0, 112, 1, 1, 1),
    (5, 6.0, 160, 1, 1, 2),
    (5, 6.0, 160, 1, 1, 1),
    (5, 6.0, 160, 1, 1, 1),
]
_TAPS = (4, 7, 13)  # block indices + 1 that end the 4x / 8x / 16x stages


class MobileNetV3Large(nn.Module):
    """Returns the pyramid [4x, 8x, 16x, 16x head] for an NHWC image."""

    def __init__(self, output_stride: int = 16, width_mult: float = 1.0):
        super().__init__()
        inp = _make_divisible(16 * width_mult)
        self.stem = conv(3, inp, 3, stride=2, bias=False)
        self.stem_bn = FoldedBN(inp)
        now_stride, rate = 2, 1
        exp = inp
        for idx, (k, t, c, se, hs, s) in enumerate(_CFGS, start=1):
            if now_stride == output_stride:
                dilation = rate
                rate *= s
                s = 1
            else:
                dilation = 1
                now_stride *= s
            oup = _make_divisible(c * width_mult)
            exp = _make_divisible(inp * t)
            setattr(self, f"block{idx}", InvertedResidualV3(
                inp, exp, oup, k, s, bool(se), bool(hs), dilation))
            inp = oup
        self.head = conv(inp, exp, 1, bias=False)
        self.head_bn = FoldedBN(exp)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = x.permute(0, 3, 1, 2).to(self.stem.weight.dtype)
        x = h_swish(self.stem_bn(self.stem(x)))
        xs = []
        for idx in range(1, len(_CFGS) + 1):
            x = getattr(self, f"block{idx}")(x)
            if idx + 1 in _TAPS:
                xs.append(x)
        x = h_swish(self.head_bn(self.head(x)))
        return (xs[0], xs[1], xs[2], x)

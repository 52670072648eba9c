"""Layer primitives. Conv feature maps are NCHW tensors (channels-last in
memory where the producer made them so); sequences are [B, HW, C].

Counterpart of `rmem_tpu/ops/layers.py`. Every module names its parameters
as the flax module does (`scale`/`bias` for norms and the frozen-BN affine,
`weight` for the flax `kernel`), so a JAX parameter tree maps onto these
modules by a fixed rule (see utils/checkpoint.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-5
GN_EPS = 1e-5


def conv(in_dim: int, out_dim: int, kernel: int, stride: int = 1,
         dilation: int = 1, bias: bool = True, groups: int = 1) -> nn.Conv2d:
    """torch conv with the symmetric padding k//2*dilation of the flax
    helper."""
    return nn.Conv2d(in_dim, out_dim, kernel, stride=stride,
                     padding=(kernel // 2) * dilation, dilation=dilation,
                     groups=groups, bias=bias)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, 2, padding=1) on NCHW: padding never wins the max."""
    return F.max_pool2d(x, 3, 2, 1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator],
              training: bool) -> torch.Tensor:
    """Stochastic depth over the batch dim: each sample kept with
    probability 1 - rate and scaled by 1 / (1 - rate), from `generator`'s
    uniform draws. The identity without a generator, at rate 0 or outside
    training."""
    if generator is None or rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    u = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), generator=generator,
                   device=x.device, dtype=x.dtype)
    return x / keep * torch.floor(keep + u)


class FoldedBN(nn.Module):
    """Frozen BatchNorm as y = x*scale + bias over the channel axis 1."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return torch.addcmul(self.bias.to(x.dtype)[:, None, None], x,
                             self.scale.to(x.dtype)[:, None, None])


class GroupNorm(nn.Module):
    """GroupNorm over the channel axis: axis 1 of an NCHW map, or the last
    axis of a [B, HW, C] sequence (the flax module's GroupNorm1D use)."""

    def __init__(self, num_groups: int, features: int, eps: float = GN_EPS):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, channels_last: bool = False):
        if channels_last:
            y = F.group_norm(x.transpose(1, 2), self.num_groups, self.scale,
                             self.bias, self.eps)
            return y.transpose(1, 2)
        return F.group_norm(x, self.num_groups, self.scale, self.bias,
                            self.eps)


class GroupNorm1D(nn.Module):
    """GroupNorm over the channel axis of [B, HW, C]."""

    def __init__(self, features: int, groups: int = 8):
        super().__init__()
        self.gn = GroupNorm(groups, features)

    def forward(self, x):
        return self.gn(x, channels_last=True)


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, self.eps)


class ConvGN(nn.Module):
    """Conv + GroupNorm on NCHW."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 gn_groups: int = 8):
        super().__init__()
        self.conv = conv(in_dim, out_dim, kernel_size)
        self.gn = GroupNorm(gn_groups, out_dim)

    def forward(self, x):
        return self.gn(self.conv(x))


def seq_to_map(x: torch.Tensor, size_2d: Tuple[int, int]) -> torch.Tensor:
    """[B, HW, C] -> NCHW view (channels-last in memory, no copy)."""
    b, hw, c = x.shape
    return x.transpose(1, 2).reshape(b, c, *size_2d)


def map_to_seq(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, HW, C]; a view when x is channels-last in memory."""
    b, c = x.shape[:2]
    return x.reshape(b, c, -1).transpose(1, 2)


class GNActDWConv2d(nn.Module):
    """GroupNorm(32) + GELU + 5x5 depthwise conv on a [B, HW, C] sequence."""

    def __init__(self, indim: int, gn_groups: int = 32):
        super().__init__()
        self.gn = GroupNorm(gn_groups, indim)
        self.conv = conv(indim, indim, 5, bias=False, groups=indim)

    def forward(self, x, size_2d: Tuple[int, int]):
        x2 = seq_to_map(x, size_2d)
        x2 = F.gelu(self.gn(x2))
        return map_to_seq(self.conv(x2))


class DWConv2d(nn.Module):
    """5x5 depthwise conv on a [B, HW, C] sequence (inference: the dropout
    of the training module is the identity)."""

    def __init__(self, indim: int):
        super().__init__()
        self.conv = conv(indim, indim, 5, bias=False, groups=indim)

    def forward(self, x, size_2d: Tuple[int, int]):
        return map_to_seq(self.conv(seq_to_map(x, size_2d)))

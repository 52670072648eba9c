"""Tiny strided-conv encoder for tests: a 3-stage conv pyramid
(4x/8x/16x + the 16x again) that keeps the whole DeAOT graph small."""

from __future__ import annotations

import torch
import torch.nn as nn

from rmem_tpu_torch.ops.layers import conv

TINY_DIMS = (32, 48, 64, 64)


class TinyEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = conv(3, TINY_DIMS[0], 5, stride=4)
        self.s8 = conv(TINY_DIMS[0], TINY_DIMS[1], 3, stride=2)
        self.s16 = conv(TINY_DIMS[1], TINY_DIMS[2], 3, stride=2)

    def forward(self, x):
        """x [B, H, W, 3] -> NCHW pyramid."""
        x = x.permute(0, 3, 1, 2).to(self.stem.weight.dtype)
        x4 = torch.relu(self.stem(x))
        x8 = torch.relu(self.s8(x4))
        x16 = torch.relu(self.s16(x8))
        return (x4, x8, x16, x16)

"""FPN segmentation head: the GPM output refined through the 16x/8x/4x
levels with encoder shortcut adapters and align-corners upsampling. NCHW.

Counterpart of `rmem_tpu/models/decoders/fpn.py`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from rmem_tpu_torch.ops.layers import ConvGN, conv
from rmem_tpu_torch.ops.resize import resize_bilinear


class FPNSegmentationHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int,
                 decode_intermediate_input: bool = True,
                 hidden_dim: int = 256,
                 shortcut_dims: Sequence[int] = (24, 32, 96, 1280),
                 align_corners: bool = True):
        super().__init__()
        hd = hidden_dim
        self.decode_intermediate_input = decode_intermediate_input
        self.align_corners = align_corners
        self.conv_in = ConvGN(in_dim, hd, 1)
        self.adapter_16x = conv(shortcut_dims[-2], hd, 1)
        self.conv_16x = ConvGN(hd, hd, 3)
        self.adapter_8x = conv(shortcut_dims[-3], hd, 1)
        self.conv_8x = ConvGN(hd, hd // 2, 3)
        self.adapter_4x = conv(shortcut_dims[-4], hd // 2, 1)
        self.conv_4x = ConvGN(hd // 2, hd // 2, 3)
        self.conv_out = conv(hd // 2, out_dim, 1)

    def forward(self, inputs: Sequence[torch.Tensor],
                shortcuts: Sequence[torch.Tensor]) -> torch.Tensor:
        """inputs: [16x projected feature, GPM outputs...] NCHW; shortcuts:
        the encoder pyramid [4x, 8x, 16x, 16x]. Returns f32 NCHW logits."""
        x = (torch.cat(list(inputs), dim=1) if self.decode_intermediate_input
             else inputs[-1])
        ac = self.align_corners
        x = torch.relu(self.conv_in(x))
        x = torch.relu(self.conv_16x(self.adapter_16x(shortcuts[-2]) + x))
        x = resize_bilinear(x, shortcuts[-3].shape[2:], ac, channel_last=False)
        x = torch.relu(self.conv_8x(self.adapter_8x(shortcuts[-3]) + x))
        x = resize_bilinear(x, shortcuts[-4].shape[2:], ac, channel_last=False)
        x = torch.relu(self.conv_4x(self.adapter_4x(shortcuts[-4]) + x))
        # logits in f32, as the JAX head computes them
        return F.conv2d(x.float(), self.conv_out.weight.float(),
                        self.conv_out.bias.float())

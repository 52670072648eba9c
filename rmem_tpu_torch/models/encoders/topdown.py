"""ResNet-50 with top-down feedback, and its reconstruction loss.

Counterpart of `rmem_tpu/models/encoders/topdown.py` on its prompt route
(the model passes no mask): a first bottom-up pass gives the 16x feature,
gated by its cosine similarity to a learned prompt and mapped by a linear
transform (identity at init); decoders (transposed convs) carry it back
down the pyramid as additive signals for a second bottom-up pass, whose
stages give the pyramid. The decoders also reconstruct each stage's input
from its (gradient-stopped) output: the mean squared errors summed are
`var_loss`, which training weighs by `Config.var_loss_weight`.

The stem is a plain conv + BN + relu + max pool (cuDNN), as the JAX package
routes it through no kernel. Transposed convs keep the flax kernel through
the weight bridge's 4-D rule, [out, in, kh, kw]; flax's ConvTranspose
correlates the dilated input with that kernel unflipped, which is PyTorch's
conv_transpose2d with the weight flipped and its channel axes swapped.
NCHW feature maps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from rmem_tpu_torch.models.encoders.resnet import Bottleneck
from rmem_tpu_torch.ops.layers import FoldedBN, conv, max_pool_3x3_s2
from rmem_tpu_torch.ops.resize import resize_bilinear


class ConvTranspose(nn.Module):
    """flax's ConvTranspose with VALID padding, then `crop` rows and columns
    off each side: PyTorch's ConvTranspose2d(padding=crop)."""

    def __init__(self, inp: int, features: int, kernel: int, stride: int,
                 crop: int, bias: bool = False):
        super().__init__()
        self.stride, self.crop = stride, crop
        self.weight = nn.Parameter(torch.zeros(features, inp, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x):
        w = self.weight.flip(2, 3).transpose(0, 1)
        return F.conv_transpose2d(x, w.to(x.dtype), None if self.bias is None
                                  else self.bias.to(x.dtype),
                                  stride=self.stride, padding=self.crop)


class _DecodeBlock(nn.Module):
    """ConvTranspose + a 1x1 head; returns (the transposed conv's map, the
    head's)."""

    def __init__(self, inp: int, out_ch: int, kernel: int, stride: int):
        super().__init__()
        self.linear = ConvTranspose(inp, out_ch, kernel, stride, kernel // 2)
        self.linear2 = conv(out_ch, out_ch, 1, bias=False)

    def forward(self, x):
        y = self.linear(x)
        return y, self.linear2(y)


class _StemDecode(nn.Module):
    """The stem's decoder: the max pool's inverse (a transposed conv with a
    bias), then a stride-2 7x7 one back to the image."""

    def __init__(self):
        super().__init__()
        self.unpool = ConvTranspose(64, 64, 3, 2, 1, bias=True)
        self.linear = ConvTranspose(64, 3, 7, 2, 3)
        self.linear2 = conv(3, 3, 1, bias=False)

    def forward(self, x):
        y = self.linear(self.unpool(x))
        return y, self.linear2(y)


class ResNet50TopDown(nn.Module):
    """forward(img [B,H,W,3]) -> (pyramid [4x, 8x, 16x, 16x], var_loss);
    var_loss is computed in training mode only (None otherwise: serving
    never reads it)."""

    DIMS = (64, 256, 512, 1024)

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FoldedBN(64)
        self.stage_names = []
        inplanes = 64
        for stage, (planes, n, stride) in enumerate(
                zip((64, 128, 256), (3, 4, 6), (1, 2, 2)), start=1):
            names = []
            for i in range(n):
                name = f"layer{stage}_{i}"
                setattr(self, name, Bottleneck(
                    inplanes, planes, stride=stride if i == 0 else 1,
                    has_downsample=(i == 0)))
                inplanes = planes * 4
                names.append(name)
            self.stage_names.append(names)
        d = self.DIMS
        self.dec0 = _StemDecode()
        self.dec1 = _DecodeBlock(d[1], d[0], 3, 1)
        self.dec2 = _DecodeBlock(d[2], d[1], 3, 2)
        self.dec3 = _DecodeBlock(d[3], d[2], 3, 2)
        self.prompt = nn.Parameter(torch.zeros(d[-1]))
        self.top_down_transform = nn.Parameter(torch.eye(d[-1]))

    @property
    def decoders(self):
        return (self.dec0, self.dec1, self.dec2, self.dec3)

    def _bottom_up(self, x, td: Optional[Tuple[torch.Tensor, ...]] = None):
        ins, outs = [x], []
        if td is not None:
            x = x + td[0]
        x = max_pool_3x3_s2(torch.relu(self.bn1(self.conv1(x))))
        outs.append(x)
        for stage, names in enumerate(self.stage_names, start=1):
            ins.append(x)
            if td is not None:
                x = x + td[stage]
            for name in names:
                x = getattr(self, name)(x)
            outs.append(x)
        return x, ins, outs

    def forward(self, img):
        x0 = img.permute(0, 3, 1, 2).to(self.conv1.weight.dtype)
        x, _, _ = self._bottom_up(x0)
        xn = x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-6)
        pn = self.prompt / (torch.linalg.vector_norm(self.prompt) + 1e-6)
        gate = torch.clamp(torch.einsum("bchw,c->bhw", xn, pn.to(xn.dtype)),
                           0, 1)[:, None]
        x = torch.einsum("bchw,cd->bdhw", x * gate,
                         self.top_down_transform.to(x.dtype))
        td = []
        for dec in reversed(self.decoders):
            x, out = dec(x)
            td.insert(0, out)
        _, ins, outs = self._bottom_up(x0, td)
        pyramid = (outs[1], outs[2], outs[3], outs[3])
        if not self.training:
            return pyramid, None
        var_loss = 0.0
        for dec, stage_out, target in zip(self.decoders, outs, ins):
            recon, _ = dec(stage_out.detach())
            t = target.detach()
            if recon.shape != t.shape:
                recon = resize_bilinear(recon, t.shape[2:],
                                        channel_last=False)
            var_loss = var_loss + torch.mean(
                (recon.float() - t.float()) ** 2)
        return pyramid, var_loss

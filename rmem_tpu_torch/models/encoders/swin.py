"""Swin Transformer backbone (Swin-B) tapped at 4x / 8x / 16x, the 16x
feature emitted twice (the 32x stage is not run).

Counterpart of `rmem_tpu/models/encoders/swin.py`: a VALID 4x4 / stride-4
patch embed (an image side that is not a multiple of 4 loses its last
rows or columns, as there), windows of 7 padded to window multiples and
cropped back, shifted windows by roll plus the image-mask trick, the
relative-position bias, the window softmax in f32, exact GELU and patch
merging that pads an odd side. The window attention is matmul + softmax,
as the JAX package computes it. Sequences are [B, HW, C]; the pyramid is
NCHW (channels-last in memory).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from rmem_tpu_torch.ops.cache import device_cache
from rmem_tpu_torch.ops.layers import LayerNorm


@functools.lru_cache(maxsize=32)
def _rel_pos_index(ws: int) -> np.ndarray:
    """[ws*ws * ws*ws] index into the (2ws-1)^2 relative bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).reshape(-1)


@functools.lru_cache(maxsize=64)
def _shift_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """Attention mask for shifted windows: [num_windows, ws*ws, ws*ws],
    -100 between tokens of different regions of the rolled map."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    return (win[:, :, None] != win[:, None, :]).astype(np.float32) * -100.0


@device_cache(16)
def _rel_pos_index_on(ws: int, device: torch.device) -> torch.Tensor:
    """_rel_pos_index copied to `device` once (a normal tensor, also when
    first asked for under inference mode, so that autograd may save it
    later): a frame reads it with no copy from the host, which a CUDA
    graph could not capture."""
    with torch.inference_mode(False):
        return torch.from_numpy(_rel_pos_index(ws)).to(device)


@device_cache(64)
def _shift_mask_on(hp: int, wp: int, ws: int, shift: int,
                   device: torch.device) -> torch.Tensor:
    """_shift_mask copied to `device` once, as _rel_pos_index_on."""
    with torch.inference_mode(False):
        return torch.from_numpy(_shift_mask(hp, wp, ws, shift)).to(device)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.dim, self.num_heads, self.window_size = (dim, num_heads,
                                                      window_size)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        """x [B*nW, ws*ws, C]; mask [nW, ws*ws, ws*ws] or None."""
        b, n, _ = x.shape
        heads = self.num_heads
        dh = self.dim // heads
        qkv = self.qkv(x).reshape(b, n, 3, heads, dh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * dh ** -0.5
        idx = _rel_pos_index_on(self.window_size, x.device)
        bias = self.relative_position_bias_table[idx].reshape(n, n, heads)
        logits = logits + bias.permute(2, 0, 1)[None].to(logits.dtype)
        if mask is not None:
            nw = mask.shape[0]
            logits = (logits.reshape(b // nw, nw, heads, n, n)
                      + mask[None, :, None].to(logits.dtype)
                      ).reshape(b, heads, n, n)
        probs = torch.softmax(logits.float(), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        return self.proj(out.reshape(b, n, self.dim))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x, hw: Tuple[int, int]):
        h, w = hw
        b, l, c = x.shape
        ws = self.window_size
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        shift = self.shift if min(hp, wp) > ws else 0
        mask = None
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = _shift_mask_on(hp, wp, ws, shift, x.device)
        xw = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
        xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        xw = self.attn(xw, mask)
        x = xw.reshape(b, hp // ws, wp // ws, ws, ws, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x[:, :h, :w].reshape(b, l, c)
        y = self.fc2(F.gelu(self.fc1(self.norm2(x))))
        return x + y


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, hw: Tuple[int, int]):
        h, w = hw
        b, l, c = x.shape
        x = F.pad(x.reshape(b, h, w, c), (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        nh, nw = x.shape[1], x.shape[2]
        x = self.reduction(self.norm(x.reshape(b, nh * nw, 4 * c)))
        return x, (nh, nw)


class SwinTransformer(nn.Module):
    """Returns the pyramid [4x, 8x, 16x, 16x] for an NHWC image."""

    def __init__(self, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18),
                 num_heads: Sequence[int] = (4, 8, 16),
                 window_size: int = 7):
        super().__init__()
        self.embed_dim, self.depths = embed_dim, tuple(depths)
        self.patch_embed = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.patch_norm = LayerNorm(embed_dim)
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            dim = embed_dim * 2 ** i
            for j in range(depth):
                setattr(self, f"stage{i}_block{j}", SwinBlock(
                    dim, heads, window_size,
                    shift=0 if j % 2 == 0 else window_size // 2))
            setattr(self, f"out_norm{i}", LayerNorm(dim))
            if i < len(depths) - 1:
                setattr(self, f"merge{i}", PatchMerging(dim))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        x = self.patch_embed(x.permute(0, 3, 1, 2).to(
            self.patch_embed.weight.dtype))
        b, c, h, w = x.shape
        x = self.patch_norm(x.flatten(2).transpose(1, 2))
        hw = (h, w)
        outs = []
        for i, depth in enumerate(self.depths):
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x, hw)
            out = getattr(self, f"out_norm{i}")(x)
            outs.append(out.transpose(1, 2).reshape(b, -1, *hw))
            if i < len(self.depths) - 1:
                x, hw = getattr(self, f"merge{i}")(x, hw)
        outs.append(outs[-1])
        return tuple(outs)


def SwinB() -> SwinTransformer:
    return SwinTransformer()

"""Spatial sine position embedding (PositionEmbeddingSine, normalize=True)."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _sine_pe_np(h: int, w: int, num_pos_feats: int, temperature: float,
                scale: float) -> np.ndarray:
    grid_y, grid_x = np.meshgrid(np.arange(h, dtype=np.float64),
                                 np.arange(w, dtype=np.float64),
                                 indexing="ij")
    eps = 1e-6
    y_embed = grid_y / (grid_y[-1:, :] + eps) * scale
    x_embed = grid_x / (grid_x[:, -1:] + eps) * scale

    dim_t = np.arange(num_pos_feats, dtype=np.float64)
    dim_t = temperature ** (2 * np.trunc(dim_t / 2) / num_pos_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack((np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])),
                     axis=3).reshape(h, w, -1)
    pos_y = np.stack((np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])),
                     axis=3).reshape(h, w, -1)
    return np.concatenate((pos_y, pos_x), axis=2).astype(np.float32)


def sine_position_embedding(h: int, w: int, channels: int,
                            temperature: float = 10000.0,
                            scale: float = 2 * math.pi,
                            device="cpu") -> torch.Tensor:
    """[1, H*W, C] sine PE (half the channels per spatial axis)."""
    pe = _sine_pe_np(h, w, channels // 2, temperature, scale)
    return torch.from_numpy(pe.reshape(1, h * w, channels)).to(device)


@functools.lru_cache(maxsize=16)
def sine_position_embedding_on(h: int, w: int, channels: int,
                               device: torch.device,
                               dtype: torch.dtype) -> torch.Tensor:
    """sine_position_embedding made once per grid, device and dtype: a
    served frame reads it without a copy from the host."""
    with torch.inference_mode(False):
        return sine_position_embedding(h, w, channels,
                                       device=device).to(dtype)

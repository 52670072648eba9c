"""Resize ops with exact torch `F.interpolate` semantics, channel-last.

Counterpart of `rmem_tpu/ops/resize.py`. Each axis is a gather of two rows
and a lerp a*wa + b*wb, with the weights rounded exactly as the JAX package
rounds them on each of its branches (integral align-corners upsampling uses
python-double `1 - s/r` and `s/r`; integral downsampling is a strided pick),
so that labels taken by argmax agree with the JAX package's.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _lerp_idx_np(n_out: int, n_in: int, align_corners: bool):
    if n_in == 1:
        lo = np.zeros(n_out, np.int64)
        return lo, lo, np.zeros(n_out, np.float32)
    if align_corners:
        if n_out == 1:
            pos = np.zeros((1,), np.float64)
        else:
            pos = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    else:
        pos = (np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out - 0.5
        pos = np.clip(pos, 0.0, n_in - 1)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    return lo, hi, (pos - lo).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _exact_lerp_coords_np(n_out: int, n_in: int, align_corners: bool):
    """(lo, hi, wa, wb) per output position: the lerp is a*wa + b*wb."""
    if align_corners and n_in > 1 and n_out > 1:
        if (n_out - 1) % (n_in - 1) == 0:
            r = (n_out - 1) // (n_in - 1)
            i = np.arange(n_out, dtype=np.int64)
            lo = i // r
            hi = np.minimum(lo + 1, n_in - 1)
            wa = np.array([1.0 - (i_ % r) / r for i_ in i], dtype=np.float32)
            wb = np.array([(i_ % r) / r for i_ in i], dtype=np.float32)
            return lo, hi, wa, wb
        if (n_in - 1) % (n_out - 1) == 0:
            r = (n_in - 1) // (n_out - 1)
            i = np.arange(n_out, dtype=np.int64) * r
            return (i, i, np.ones(n_out, np.float32),
                    np.zeros(n_out, np.float32))
    lo, hi, w = _lerp_idx_np(n_out, n_in, align_corners)
    return lo, hi, np.float32(1.0) - w, w


@functools.lru_cache(maxsize=256)
def _lerp_coords_on(n_out: int, n_in: int, align_corners: bool,
                    device: torch.device):
    """The coordinates as tensors on `device`, copied there once."""
    lo, hi, wa, wb = _exact_lerp_coords_np(n_out, n_in, align_corners)
    return (*(torch.from_numpy(a).to(device) for a in (lo, hi, wa, wb)),
            not wb.any())


def _lerp_axis(x: torch.Tensor, n_out: int, axis: int,
               align_corners: bool) -> torch.Tensor:
    n_in = x.shape[axis]
    if n_in == n_out:
        return x
    lo, hi, wa, wb, pick = _lerp_coords_on(n_out, n_in, align_corners,
                                           x.device)
    if pick:     # strided pick: no arithmetic
        return x.index_select(axis, lo)
    shape = [1] * x.dim()
    shape[axis] = n_out
    return (x.index_select(axis, lo) * wa.view(shape)
            + x.index_select(axis, hi) * wb.view(shape))


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = True,
                    channel_last: bool = True) -> torch.Tensor:
    """Bilinear resize of [B,H,W,C] (or [B,C,H,W]), computed in f32."""
    H, W = out_hw
    ax = (1, 2) if channel_last else (2, 3)
    if (x.shape[ax[0]], x.shape[ax[1]]) == (H, W):
        return x
    y = x.to(torch.float32)
    y = _lerp_axis(y, H, ax[0], align_corners)
    y = _lerp_axis(y, W, ax[1], align_corners)
    return y.to(x.dtype)


def upsample_argmax(x: torch.Tensor, out_hw: Tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """`argmax_c(resize_bilinear(x, out_hw)[0])` for x [1, h, w, c], as
    int32 [H, W].

    Integral align-corners upsampling on both axes factors into ry*rx
    constant-weight phases on the small grid, each with its own argmax, so
    the [H, W, c] float tensor is never built; other sizes take the generic
    resize and argmax."""
    H, W = out_hw
    b, h, w, c = x.shape
    if b != 1:
        raise ValueError(f"upsample_argmax expects batch 1, got {b}")
    ry = (H - 1) // (h - 1) if h > 1 and (H - 1) % (h - 1) == 0 else 0
    rx = (W - 1) // (w - 1) if w > 1 and (W - 1) % (w - 1) == 0 else 0
    if not (align_corners and ry >= 1 and rx >= 1 and (ry > 1 or rx > 1)):
        y = resize_bilinear(x, out_hw, align_corners)
        return torch.argmax(y[0], dim=-1).to(torch.int32)
    L = x[0].to(torch.float32)
    Ldy = torch.cat([L[1:], L[-1:]], dim=0)
    phases = []
    for py in range(ry):
        wy = py / ry
        A = L * (1.0 - wy) + Ldy * wy if ry > 1 else L
        Adx = torch.cat([A[:, 1:], A[:, -1:]], dim=1)
        for px in range(rx):
            wx = px / rx
            P = A * (1.0 - wx) + Adx * wx if rx > 1 else A
            phases.append(torch.argmax(P, dim=-1).to(torch.int32))
    lab = torch.stack(phases, 0).reshape(ry, rx, h, w)
    lab = lab.permute(2, 0, 3, 1).reshape(h * ry, w * rx)
    return lab[:(h - 1) * ry + 1, :(w - 1) * rx + 1]


@functools.lru_cache(maxsize=256)
def _nearest_idx_np(n_out: int, n_in: int) -> np.ndarray:
    # torch mode='nearest': src = floor(i * n_in / n_out)
    idx = np.floor(np.arange(n_out, dtype=np.float64) * n_in / n_out)
    return np.clip(idx.astype(np.int64), 0, n_in - 1)


@functools.lru_cache(maxsize=64)
def _nearest_idx_on(H: int, h: int, W: int, w: int, device: torch.device):
    return (torch.from_numpy(_nearest_idx_np(H, h)).to(device),
            torch.from_numpy(_nearest_idx_np(W, w)).to(device))


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int],
                   channel_last: bool = True) -> torch.Tensor:
    """Nearest resize matching torch `F.interpolate(mode='nearest')`."""
    H, W = out_hw
    ax = (1, 2) if channel_last else (2, 3)
    h, w = x.shape[ax[0]], x.shape[ax[1]]
    if (h, w) == (H, W):
        return x
    iy, ix = _nearest_idx_on(H, h, W, w, x.device)
    return x.index_select(ax[0], iy).index_select(ax[1], ix)

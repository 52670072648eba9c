"""Eval-time frame geometry and normalisation constants, numpy only.

A copy of the jax-free helpers of `rmem_tpu/data/transforms.py` that the
engine's on-card frame prep needs: MultiRestrictSize's target size (long
edge capped at test_max_size or short edge at test_min_size, times the
aug's scale, snapped to the stride-16 grid, +1 with align_corners) and the
ImageNet mean and std.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def snap_stride(n: int, stride: int = 16, align_corners: bool = True) -> int:
    """Snap a length to the stride grid (n = k * stride, + 1 with
    align_corners)."""
    if align_corners:
        if (n - 1) % stride != 0:
            n = int(np.around((n - 1) / stride) * stride + 1)
    else:
        if n % stride != 0:
            n = int(np.around(n / stride) * stride)
    return n


def restrict_size(h: int, w: int, max_size: Optional[float] = 800 * 1.3,
                  min_size: Optional[float] = None, scale: float = 1.0,
                  align_corners: bool = True, stride: int = 16
                  ) -> Tuple[int, int]:
    """The model input size (H, W) of an h x w frame under one aug."""
    sc = None
    if min_size is not None:
        short = min(h, w)
        if short > min_size:
            sc = float(min_size) / short
    else:
        long_edge = max(h, w)
        if max_size is not None and long_edge > max_size:
            sc = float(max_size) / long_edge
    nh, nw = (h, w) if sc is None else (sc * h, sc * w)
    nh, nw = int(nh * scale), int(nw * scale)
    return (snap_stride(nh, stride, align_corners),
            snap_stride(nw, stride, align_corners))

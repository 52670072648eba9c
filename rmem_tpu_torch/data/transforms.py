"""Eval-time frame geometry, label resizing and normalisation, numpy only.

A copy of the jax-free helpers of `rmem_tpu/data/transforms.py` that the
evaluator needs: MultiRestrictSize's target size (long edge capped at
test_max_size or short edge at test_min_size, times the aug's scale,
snapped to the stride-16 grid, +1 with align_corners), the nearest resize
of labels with torch's index rule, and the ImageNet normalisation. Frames
are resized and normalised on the engine's device (`InferenceEngine.prep`),
not here: the JAX package's cv2 `resize_image` is not ported.
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


def resize_label(label: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Nearest resize with torch `F.interpolate(mode='nearest')`'s index
    rule, src = floor(dst * in / out), in integers."""
    if label.shape[:2] == tuple(hw):
        return label
    h_in, w_in = label.shape[:2]
    rows = (np.arange(hw[0]) * h_in // hw[0]).astype(np.int64)
    cols = (np.arange(hw[1]) * w_in // hw[1]).astype(np.int64)
    return label[rows][:, cols]


def normalize_image(img: np.ndarray) -> np.ndarray:
    """HWC pixels in 0..255 -> float32 (x / 255 - mean) / std."""
    x = img.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD

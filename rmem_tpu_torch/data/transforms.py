"""Frame geometry, label resizing, normalisation and the training clips'
augmentation.

Counterpart of `rmem_tpu/data/transforms.py`. For the evaluator:
MultiRestrictSize's target size (long edge capped at test_max_size or
short edge at test_min_size, times the aug's scale, snapped to the
stride-16 grid, +1 with align_corners), the nearest resize of labels with
torch's index rule, and the ImageNet normalisation. Eval frames are
resized and normalised on the engine's device (`InferenceEngine.prep`).

For training: `random_scale`, `balanced_random_crop` and `random_hflip`
take a clip's frames as one tensor [T, H, W, 3] of pixel values 0..255
(on the card, or on the CPU) and its labels as host arrays, and draw from
the caller's np.random.RandomState exactly as the JAX functions draw. The
labels' work (resize, pad, crop window search, relabel, flip) runs on the
host, where the draws depend on it; the pixels' on the frames' device,
queued without a read back. The scale is cv2's INTER_CUBIC in f32
(ops/resize.py:resize_cubic) rounded and clamped to 0..255, as cv2's uint8
resize saturates; cv2 computes it in fixed point, so a pixel may differ by
one level.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from rmem_tpu_torch.ops.resize import resize_cubic

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


# ---- training-time augmentation -------------------------------------------

def resize_pixels(imgs: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """[T, H, W, 3] pixel values -> f32 [T, h, w, 3] by cv2's uint8
    INTER_CUBIC: the cubic resize, rounded and clamped to 0..255."""
    if tuple(imgs.shape[1:3]) == tuple(hw):
        return imgs.to(torch.float32)
    return resize_cubic(imgs, hw).round_().clamp_(0.0, 255.0)


def random_scale(imgs: torch.Tensor, labels: List[np.ndarray],
                 rng: np.random.RandomState, short_edge: int = 480,
                 min_factor: float = 0.7, max_factor: float = 1.3):
    """Scale the clip so its short side is short_edge times a factor drawn
    in [min_factor, max_factor): the frames by resize_pixels, the labels
    by resize_label."""
    h, w = imgs.shape[1:3]
    factor = rng.uniform(min_factor, max_factor)
    sc = short_edge * factor / min(h, w)
    nh, nw = int(round(h * sc)), int(round(w * sc))
    return (resize_pixels(imgs, (nh, nw)),
            [resize_label(lb, (nh, nw)) for lb in labels])


def balanced_random_crop(imgs: torch.Tensor, labels: List[np.ndarray],
                         rng: np.random.RandomState,
                         crop_hw: Tuple[int, int] = (465, 465),
                         max_steps: int = 10, ignore_thresh: float = 0.2):
    """A crop_hw window, zero-padded at the bottom and right where the clip
    is smaller: up to max_steps windows are drawn until the first frame's
    window holds an object and at most ignore_thresh of it is ignored
    (255); else the first. The labels are then renumbered 1..n by the
    objects of the first frame's window (others become 0). Returns
    (frames, labels, n)."""
    ch, cw = crop_hw
    t, h, w = imgs.shape[:3]
    pad_h, pad_w = max(ch - h, 0), max(cw - w, 0)
    if pad_h or pad_w:
        padded = imgs.new_zeros((t, h + pad_h, w + pad_w, imgs.shape[3]))
        padded[:, :h, :w] = imgs
        imgs = padded
        labels = [np.pad(lb, ((0, pad_h), (0, pad_w))) for lb in labels]
        h, w = h + pad_h, w + pad_w
    best = None
    for _ in range(max_steps):
        y = rng.randint(0, h - ch + 1)
        x = rng.randint(0, w - cw + 1)
        ref = labels[0][y:y + ch, x:x + cw]
        fg = ref[(ref > 0) & (ref != 255)]
        ok_ignore = float((ref == 255).sum()) / ref.size <= ignore_thresh
        if fg.size > 0 and ok_ignore:
            best = (y, x)
            break
        if best is None:
            best = (y, x)
    y, x = best
    imgs = imgs[:, y:y + ch, x:x + cw]
    labels = [lb[y:y + ch, x:x + cw] for lb in labels]
    obj_ids = sorted(int(i) for i in np.unique(labels[0]) if i not in (0, 255))
    lut = np.zeros(256, np.uint8)
    lut[255] = 255
    for new_id, old_id in enumerate(obj_ids, start=1):
        lut[old_id] = new_id
    return imgs, [lut[lb.astype(np.uint8)] for lb in labels], len(obj_ids)


def random_hflip(imgs: torch.Tensor, labels: List[np.ndarray],
                 rng: np.random.RandomState, prob: float = 0.5):
    """Flip the clip left to right with probability prob."""
    if rng.rand() < prob:
        return imgs.flip(2), [lb[:, ::-1].copy() for lb in labels]
    return imgs, labels


def normalize_pixels(imgs: torch.Tensor) -> torch.Tensor:
    """Pixel values 0..255 -> f32 (x / 255 - mean) / std, as
    normalize_image on the frames' device."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=imgs.device)
    std = torch.as_tensor(IMAGENET_STD, device=imgs.device)
    return (imgs.to(torch.float32) / 255.0 - mean) / std

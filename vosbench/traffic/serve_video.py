"""Seeded synthetic videos for serving: raw uint8 RGB frames of moving
soft-edged shapes over a smooth background, and the first frame's mask,
made on the device from the seed alone.

Parameters (a workload file's `video` block): `raw_hw` the frame size,
`objects` the shapes (each its own object id, later ones on top), `frames`
the video's length. Every seed gives the same sizes, object count and
length; the seed moves the shapes, their colours and the background.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BATCH = 16      # frames made per call


def make_video(params: Dict, seed: int, device) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """(frames uint8 [T, H, W, 3], mask int64 [H, W] of frame 0 with ids
    0..objects) on `device`."""
    h, w = params["raw_hw"]
    n, t = params["objects"], params["frames"]
    rng = np.random.default_rng(seed)
    start = rng.uniform(0.15, 0.85, (n, 2))
    speed = rng.uniform(-0.006, 0.006, (n, 2))
    size = rng.uniform(0.05, 0.09, (n, 2))
    color = torch.from_numpy(rng.uniform(0.2, 0.45, (n, 3))).float().to(
        device)
    g = torch.Generator(device=device).manual_seed(
        int(rng.integers(0, 2 ** 62)))
    low = torch.rand((1, 3, h // 8, w // 8), generator=g, device=device)
    base = F.interpolate(low, size=(h, w), mode="bicubic",
                         align_corners=False)[0].permute(1, 2, 0) * 0.5
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    frames = torch.empty((t, h, w, 3), dtype=torch.uint8, device=device)
    mask = None
    for t0 in range(0, t, BATCH):
        ts = np.arange(t0, min(t0 + BATCH, t))
        # positions bounce between 0.05 and 0.95 of the frame
        pos = start[None] + speed[None] * ts[:, None, None]
        pos = 0.05 + 0.9 * np.abs(((pos - 0.05) / 0.9 + 1) % 2 - 1)
        pos = torch.from_numpy(pos * (h, w)).float().to(device)  # [K, n, 2]
        img = base.expand(len(ts), h, w, 3).clone()
        lab = torch.zeros((len(ts), h, w), dtype=torch.int64, device=device)
        for i in range(n):
            cy = pos[:, i, 0, None, None]
            cx = pos[:, i, 1, None, None]
            blob = torch.exp(-(((yy - cy) / (size[i, 0] * h)) ** 2
                               + ((xx - cx) / (size[i, 1] * w)) ** 2))
            img = img + blob[..., None] * color[i]
            lab = torch.where(blob > 0.55, i + 1, lab)
        frames[t0:t0 + len(ts)] = (img.clamp(0, 1) * 255.0).round().to(
            torch.uint8)
        if mask is None:
            mask = lab[0]
    return frames, mask

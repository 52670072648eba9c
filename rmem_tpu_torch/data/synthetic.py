"""Seeded synthetic training clips, made on the device.

Counterpart of `rmem_tpu/data/synthetic.py` (the same clip family, not the
same random draws): a smooth random background and 2..max_objs moving
coloured disks whose coverage gives the labels; disks wrap around the
image and later objects draw over earlier ones. Every draw comes from an
explicit torch.Generator on the batch's device, so a clip costs no host to
device copy and batch i is a function of (seed, i).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from rmem_tpu_torch.ops.resize import resize_bilinear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def gen_blob_batch(gen: torch.Generator, batch: int, seq_len: int,
                   hw: Tuple[int, int], max_objs: int = 3
                   ) -> Dict[str, torch.Tensor]:
    """imgs [B,T,H,W,3] normalized f32, labels [B,T,H,W] int32, obj_nums
    [B] int32, on the generator's device."""
    dev = gen.device
    h, w = hw
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    base = u(batch, h // 8 + 2, w // 8 + 2, 3)
    base = resize_bilinear(base, (h, w), align_corners=False) * 255.0
    n_obj = torch.randint(2, max_objs + 1, (batch,), generator=gen,
                          device=dev)
    cy, cx = u(batch, max_objs) * h, u(batch, max_objs) * w
    vy = torch.randn((batch, max_objs), generator=gen, device=dev) * 4.0
    vx = torch.randn((batch, max_objs), generator=gen, device=dev) * 4.0
    r = torch.randint(25, 60, (batch, max_objs), generator=gen,
                      device=dev).float()
    ids = torch.arange(max_objs, device=dev, dtype=torch.float32)
    colors = torch.stack([40.0 * (ids + 1), 255.0 - 60.0 * ids,
                          torch.full_like(ids, 128.0)], dim=-1)   # [O, 3]
    t = torch.arange(seq_len, device=dev, dtype=torch.float32)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]

    imgs = base[:, None].expand(batch, seq_len, h, w, 3).clone()
    labels = torch.zeros((batch, seq_len, h, w), dtype=torch.int32,
                         device=dev)
    for i in range(max_objs):
        py = torch.remainder(cy[:, i, None] + vy[:, i, None] * t, h)  # [B,T]
        px = torch.remainder(cx[:, i, None] + vx[:, i, None] * t, w)
        inside = ((yy - py[..., None, None]) ** 2
                  + (xx - px[..., None, None]) ** 2
                  < r[:, i, None, None, None] ** 2)
        inside &= (i < n_obj)[:, None, None, None]
        imgs = torch.where(inside[..., None], colors[i], imgs)
        labels = torch.where(inside, i + 1, labels)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    return {"imgs": (imgs / 255.0 - mean) / std, "labels": labels,
            "obj_nums": n_obj.to(torch.int32)}

"""A seeded pool of training clips made on the device: a smooth random
background and 2..`max_objects` moving coloured disks whose coverage gives
the labels, disks wrapping around the image and later objects drawn over
earlier ones (the synthetic clip family of the package's own tests, made
here from the seed alone).

Parameters (a workload file's `clips` block): `clips` the pool's size,
`max_objects`; the clip length and crop are the configuration's
(`data_seq_len`, `data_randomcrop`). Every seed gives the same sizes.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
PER_CALL = 4     # clips made per call


def _clips(gen: torch.Generator, batch: int, seq: int, hw: Tuple[int, int],
           max_objs: int) -> Dict[str, torch.Tensor]:
    dev = gen.device
    h, w = hw
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    base = F.interpolate(u(batch, 3, h // 8 + 2, w // 8 + 2), size=(h, w),
                         mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1) * 255.0
    n_obj = torch.randint(2, max_objs + 1, (batch,), generator=gen,
                          device=dev)
    cy, cx = u(batch, max_objs) * h, u(batch, max_objs) * w
    vy = torch.randn((batch, max_objs), generator=gen, device=dev) * 4.0
    vx = torch.randn((batch, max_objs), generator=gen, device=dev) * 4.0
    r = torch.randint(25, 60, (batch, max_objs), generator=gen,
                      device=dev).float()
    ids = torch.arange(max_objs, device=dev, dtype=torch.float32)
    colors = torch.stack([(40.0 * (ids + 1)) % 256, (255.0 - 60.0 * ids) % 256,
                          torch.full_like(ids, 128.0)], -1)
    t = torch.arange(seq, device=dev, dtype=torch.float32)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    imgs = base[:, None].expand(batch, seq, h, w, 3).clone()
    labels = torch.zeros((batch, seq, h, w), dtype=torch.int32, device=dev)
    for i in range(max_objs):
        py = torch.remainder(cy[:, i, None] + vy[:, i, None] * t, h)
        px = torch.remainder(cx[:, i, None] + vx[:, i, None] * t, w)
        inside = ((yy - py[..., None, None]) ** 2
                  + (xx - px[..., None, None]) ** 2
                  < r[:, i, None, None, None] ** 2)
        inside &= (i < n_obj)[:, None, None, None]
        imgs = torch.where(inside[..., None], colors[i], imgs)
        labels = torch.where(inside, i + 1, labels)
    mean = torch.tensor(MEAN, device=dev)
    std = torch.tensor(STD, device=dev)
    return {"imgs": (imgs / 255.0 - mean) / std, "labels": labels,
            "obj_nums": n_obj.to(torch.int32)}


def make_pool(params: Dict, seq: int, hw: Tuple[int, int], seed: int,
              device) -> Dict[str, torch.Tensor]:
    """The pool: imgs f32 [N, T, H, W, 3] (normalised), labels int32
    [N, T, H, W], obj_nums int32 [N]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    parts = [_clips(gen, min(PER_CALL, params["clips"] - i), seq, hw,
                    params["max_objects"])
             for i in range(0, params["clips"], PER_CALL)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def batches(pool: Dict[str, torch.Tensor], batch: int
            ) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless batches of `batch` consecutive pool clips, cycling: the
    first len(pool) // batch batches are all distinct clips."""
    n = pool["imgs"].shape[0]
    i = 0
    while True:
        idx = torch.arange(i, i + batch, device=pool["imgs"].device) % n
        yield {k: v.index_select(0, idx) for k, v in pool.items()}
        i = (i + batch) % n

"""Online training metrics: the reference's train-time IoU and a windowed
running mean. Counterpart of `rmem_tpu/utils/metric.py`."""

from __future__ import annotations

import numpy as np
import torch


def pytorch_iou_batched(pred: torch.Tensor, target: torch.Tensor,
                        obj_nums: torch.Tensor, max_obj: int,
                        epsilon: float = 1e-6) -> torch.Tensor:
    """Per batch item, the mean foreground IoU over that item's objects;
    items with no object are skipped; a batch with none gives 1.
    pred/target [B,H,W] int; obj_nums [B]. Returns a 0-d tensor."""
    ids = torch.arange(1, max_obj + 1, device=pred.device)[None, :, None,
                                                           None]
    p = pred[:, None] == ids                                  # [B,O,H,W]
    t = target[:, None] == ids
    inter = (p & t).sum(dim=(-2, -1)).float()
    union = (p | t).sum(dim=(-2, -1)).float()
    iou = (inter + epsilon) / (union + epsilon)
    valid = (ids[0, :, 0, 0][None] <= obj_nums[:, None]).float()
    per_item = (iou * valid).sum(-1) / torch.clamp(valid.sum(-1), min=1.0)
    has = (obj_nums > 0).float()
    mean = (per_item * has).sum() / torch.clamp(has.sum(), min=1.0)
    return torch.where(has.sum() > 0, mean, torch.ones_like(mean))


class AverageMeter:
    """Running mean over the last `window` values."""

    def __init__(self, window: int = 100):
        self.window = window
        self.vals = []

    def update(self, v: float) -> None:
        self.vals.append(float(v))
        if len(self.vals) > self.window:
            self.vals.pop(0)

    @property
    def avg(self) -> float:
        return float(np.mean(self.vals)) if self.vals else 0.0

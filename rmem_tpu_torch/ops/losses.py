"""Training losses: bootstrapped (top-k) cross-entropy and soft Jaccard,
0.5 each per frame.

Counterpart of `rmem_tpu/ops/losses.py`. k anneals with the step from all
pixels to `top_k_percent` of them, and the top k follow torch.topk's
selection with ties at the threshold going to the lowest pixel index (a
stable descending sort), as the JAX package's radix select does. Channels
beyond each sample's object count are masked; ignored pixels (255) add no
loss but stay in the top-k pool.
"""

from __future__ import annotations

import numpy as np
import torch

IGNORE_LABEL = 255
_NEG = -1e30


def _valid_class_logits(logits: torch.Tensor, obj_nums: torch.Tensor):
    """logits [N, H, W, C], obj_nums [N]: channels > obj_num masked."""
    c = logits.shape[-1]
    valid = torch.arange(c, device=logits.device)[None] <= obj_nums[:, None]
    return torch.where(valid[:, None, None], logits, _NEG), valid


def topk_count(num_pixels: int, step: float, top_k_percent: float,
               hard_mining_steps: float) -> int:
    """k for this step, evaluated in f32 as the JAX package does."""
    f = np.float32
    ratio = np.minimum(f(1.0), f(step) / f(hard_mining_steps))
    k = np.floor((ratio * f(top_k_percent) + (f(1.0) - ratio))
                 * f(num_pixels))
    return int(max(k, f(1.0)))


def cross_entropy_topk(logits: torch.Tensor, label: torch.Tensor,
                       obj_nums: torch.Tensor, step: float,
                       top_k_percent: float = 0.15,
                       hard_mining_steps: float = 10_000.0) -> torch.Tensor:
    """Per-sample bootstrapped CE: logits [N,H,W,C], label [N,H,W] -> [N]."""
    n, h, w, c = logits.shape
    logits, _ = _valid_class_logits(logits, obj_nums)
    logp = torch.log_softmax(logits.float(), dim=-1)
    lbl = torch.clamp(label, 0, c - 1).long()
    pix = -torch.gather(logp, -1, lbl[..., None])[..., 0]
    pix = torch.where(label == IGNORE_LABEL, 0.0, pix).reshape(n, -1)
    k = topk_count(h * w, step, top_k_percent, hard_mining_steps)
    # the k largest, ties to the lowest index: selected under no gradient,
    # so the gradient is 1/k on exactly the selected pixels
    idx = torch.sort(pix.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :k]
    return torch.gather(pix, 1, idx).sum(-1) / k


def soft_jaccard(logits: torch.Tensor, label: torch.Tensor,
                 obj_nums: torch.Tensor,
                 epsilon: float = 1e-6) -> torch.Tensor:
    """Per-sample soft Jaccard over the classes present in the ground
    truth, ignored pixels excluded: [N,H,W,C], [N,H,W] -> [N]."""
    c = logits.shape[-1]
    logits, class_valid = _valid_class_logits(logits, obj_nums)
    probs = torch.softmax(logits.float(), dim=-1)
    pix_valid = (label != IGNORE_LABEL)[..., None].float()
    ids = torch.arange(c, device=label.device)
    gt = (label[..., None] == ids).float() * pix_valid
    probs = probs * pix_valid
    num = (probs * gt).sum(dim=(1, 2))                        # [N, C]
    gt_sum = gt.sum(dim=(1, 2))
    den = probs.sum(dim=(1, 2)) + gt_sum - num
    loss_c = 1.0 - num / (den + epsilon)
    present = ((gt_sum > 0) & class_valid).float()
    return (loss_c * present).sum(-1) / torch.clamp(present.sum(-1), min=1.0)


def segmentation_loss(logits: torch.Tensor, label: torch.Tensor,
                      obj_nums: torch.Tensor, step: float,
                      top_k_percent: float = 0.15,
                      hard_mining_steps: float = 10_000.0,
                      ce_weight: float = 0.5,
                      jaccard_weight: float = 0.5) -> torch.Tensor:
    """0.5 * CE + 0.5 * Jaccard per sample: logits [N,H,W,C] at full
    resolution, label [N,H,W], obj_nums [N] -> [N]."""
    ce = cross_entropy_topk(logits, label, obj_nums, step, top_k_percent,
                            hard_mining_steps)
    jac = soft_jaccard(logits, label, obj_nums)
    return ce_weight * ce + jaccard_weight * jac

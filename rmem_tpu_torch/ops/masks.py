"""Mask helpers: one-hot with the 255 ignore label, unused-id masking."""

from __future__ import annotations

import torch


def one_hot_mask(mask: torch.Tensor, max_obj_num: int):
    """mask [B,H,W] int -> (one_hot [B,H,W,obj+1], ignore [B,H,W,1]) f32.

    Channel-last; label 255 marks ignore."""
    if mask.dim() == 4:
        mask = mask[..., 0]
    ids = torch.arange(max_obj_num + 1, dtype=mask.dtype, device=mask.device)
    one_hot = (mask[..., None] == ids).to(torch.float32)
    ignore = (mask[..., None] == 255).to(torch.float32)
    return one_hot, ignore


def mask_unused_ids(logits: torch.Tensor, obj_nums: torch.Tensor,
                    neg: float = -1e10) -> torch.Tensor:
    """Disable id channels beyond each sample's object count.
    logits [B,H,W,C] channel-last, obj_nums [B] int."""
    c = logits.shape[-1]
    ch = torch.arange(c, device=logits.device)
    valid = ch[None, :] <= obj_nums[:, None]
    return torch.where(valid[:, None, None, :], logits,
                       torch.full((), neg, dtype=logits.dtype,
                                  device=logits.device))

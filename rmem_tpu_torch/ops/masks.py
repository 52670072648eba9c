"""Mask helpers: one-hot with the 255 ignore label, unused-id masking, and
the training-time id shuffle (aot_engine.py:208-232, 444-453 in the
reference; rmem_tpu/ops/masks.py and engine/training.py:102-119)."""

from __future__ import annotations

from typing import Optional

import numpy as np
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


def host_id_shuffle_matrix(rng, dim: int, batch: int,
                           keep_first: bool = True) -> np.ndarray:
    """[batch, dim, dim] f32 permutation matrices drawn on the host from
    `rng` (np.random.RandomState), row 0 (background) pinned: the same draws
    as the JAX package's host_id_shuffle_matrix for the same rng state."""
    eye = np.eye(dim, dtype=np.float32)
    out = np.zeros((batch, dim, dim), np.float32)
    for i in range(batch):
        if keep_first:
            rows = np.concatenate([[0], rng.permutation(dim - 1) + 1])
        else:
            rows = rng.permutation(dim)
        out[i] = eye[rows]
    return out


def unshuffle_logits(logits: torch.Tensor,
                     shuffle: torch.Tensor) -> torch.Tensor:
    """Undo the id shuffle on predicted logits [B,H,W,C]: channel o takes
    the logit of the channel it was shuffled to."""
    return torch.einsum("bhwo,bto->bhwt", logits, shuffle.to(logits.dtype))


def map_id_label(label: torch.Tensor, perm: Optional[torch.Tensor],
                 max_obj_num: int) -> torch.Tensor:
    """Raw label plane [B,H,W] (255 = ignore) -> id-bank channel plane:
    channel perm[b, label] (perm [B, obj+1] from the shuffle, or the
    identity), 255 -> the ignore channel obj+1."""
    safe = torch.clamp(label, 0, max_obj_num).long()
    if perm is not None:
        b = safe.shape[0]
        safe = torch.gather(perm.long(), 1, safe.reshape(b, -1)
                            ).reshape(safe.shape)
    return torch.where(label == 255, max_obj_num + 1, safe)

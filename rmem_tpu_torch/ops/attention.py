"""Attention ops in plain PyTorch: the formulations the CUDA kernels are held
to, and the gated self-attention that has no kernel.

Counterpart of `rmem_tpu/ops/attention.py`:

- `multihead_attention`: scaled dot-product over [B, L, C] sequences, f32
  softmax.
- `bank_attention`: the current frame's queries into S fixed slots of the
  long-term bank, invalid slots and key padding masked, with an optional
  per-(query, slot) logit bias (the factored slot temporal PE) and the
  per-slot attention mass that eviction reads.
- `dense_local_attention`: DeAOT's (2m+1)^2 window attention as masked
  dense attention with the learned relative bias gathered into dense form.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q [B,Lq,C], k [B,Lk,C], v [B,Lk,Cv] -> [B,Lq,Cv]."""
    b, lq, c = q.shape
    dh = c // num_heads
    dv = v.shape[-1] // num_heads
    scale = scale if scale is not None else dh ** -0.5
    qh = q.reshape(b, lq, num_heads, dh).transpose(1, 2)
    kh = k.reshape(b, -1, num_heads, dh).transpose(1, 2)
    vh = v.reshape(b, -1, num_heads, dv).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    out = torch.matmul(probs.to(v.dtype), vh)            # [b, h, lq, dv]
    return out.transpose(1, 2).reshape(b, lq, num_heads * dv)


def bank_attention(q: torch.Tensor, bank_k: torch.Tensor,
                   bank_v: torch.Tensor, slot_mask: torch.Tensor,
                   num_heads: int, need_record: bool = False,
                   scale: Optional[float] = None,
                   true_lk: Optional[int] = None,
                   logit_bias: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Cross-attention from the current frame into the memory bank.

    q [B, Lq, Ck]; bank_k [S, B, Lk, Ck]; bank_v [S, B, Lk, Cv]; slot_mask
    [S] bool; logit_bias [B, h, Lq, S] pre-scaled. Returns (out [B, Lq, Cv],
    record [B, Lq, S] or None): the head-mean softmax mass of each slot,
    which sums to 1 over the valid slots of each query.
    """
    s, b, lk, ck = bank_k.shape
    lq = q.shape[1]
    dh = ck // num_heads
    dv = bank_v.shape[-1] // num_heads
    scale = scale if scale is not None else dh ** -0.5

    qh = q.reshape(b, lq, num_heads, dh)
    kh = bank_k.reshape(s, b, lk, num_heads, dh)
    vh = bank_v.reshape(s, b, lk, num_heads, dv)
    logits = torch.einsum("bqhd,sbkhd->bhqsk", qh, kh) * scale
    if logit_bias is not None:
        logits = logits + logit_bias[..., None].to(logits.dtype)
    neg = torch.full((), NEG_INF, dtype=logits.dtype, device=logits.device)
    logits = torch.where(slot_mask[None, None, None, :, None], logits, neg)
    if true_lk is not None and true_lk < lk:
        keep = torch.arange(lk, device=logits.device) < true_lk
        logits = torch.where(keep, logits, neg)
    flat = logits.reshape(b, num_heads, lq, s * lk).to(torch.float32)
    probs = torch.softmax(flat, dim=-1).reshape(b, num_heads, lq, s, lk)
    out = torch.einsum("bhqsk,sbkhd->bqhd", probs.to(bank_v.dtype), vh)
    out = out.reshape(b, lq, num_heads * dv)
    record = probs.mean(dim=1).sum(dim=-1) if need_record else None
    return out, record


def slot_pe_bias(q: torch.Tensor, slot_pe: torch.Tensor, num_heads: int,
                 scale: float) -> torch.Tensor:
    """Factored slot temporal PE: the pre-scaled [B, h, Lq, S] logit bias.

    Exact because the PE is constant across a slot's tokens:
    (q.(k + pe_s)) * scale == q.k * scale + (q.pe_s) * scale."""
    b, lq, ck = q.shape
    dh = ck // num_heads
    qh = q.reshape(b, lq, num_heads, dh).to(torch.float32)
    peh = slot_pe.reshape(slot_pe.shape[0], num_heads, dh).to(torch.float32)
    return (torch.einsum("bqhd,shd->bhqs", qh, peh) * scale).contiguous()


@functools.lru_cache(maxsize=16)
def _local_offset_map(h: int, w: int, max_dis: int) -> np.ndarray:
    """[HW, HW] int64: key position -> window offset in [0, win^2), or
    win^2 (the sentinel) outside the window."""
    win = 2 * max_dis + 1
    qy, qx = np.divmod(np.arange(h * w), w)
    dy = qy[None, :] - qy[:, None]
    dx = qx[None, :] - qx[:, None]
    inside = (np.abs(dy) <= max_dis) & (np.abs(dx) <= max_dis)
    off = (dy + max_dis) * win + (dx + max_dis)
    return np.where(inside, off, win * win).astype(np.int64)


@functools.lru_cache(maxsize=16)
def _local_offset_map_on(h: int, w: int, max_dis: int,
                         device: torch.device) -> torch.Tensor:
    # a normal tensor, also when first asked for under inference mode, so
    # that autograd may save it later
    with torch.inference_mode(False):
        return torch.from_numpy(_local_offset_map(h, w, max_dis)).to(device)


def dense_local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          rel_emb: torch.Tensor, size_2d: Tuple[int, int],
                          num_heads: int, max_dis: int = 7,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Windowed local attention as masked dense attention.

    q, k [B, HW, h*d]; v [B, HW, h*dv]; rel_emb [B, HW, h*(2m+1)^2], the
    learned relative bias made from the unscaled q. Each query's softmax
    runs over the keys of its window that lie in the image; keys beyond
    the image do not exist here, so grids smaller than the window need no
    special case (the relative table is read at its centre).
    """
    h2d, w2d = size_2d
    b, hw, chd = q.shape
    dh = chd // num_heads
    dv = v.shape[-1] // num_heads
    win2 = (2 * max_dis + 1) ** 2
    scale = scale if scale is not None else dh ** -0.5
    omap = _local_offset_map_on(h2d, w2d, max_dis, q.device)   # [HW, HW]

    qh = q.reshape(b, hw, num_heads, dh).transpose(1, 2)
    kh = k.reshape(b, hw, num_heads, dh).transpose(1, 2)
    vh = v.reshape(b, hw, num_heads, dv).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale   # [b,h,q,k]

    rel = rel_emb.reshape(b, hw, num_heads, win2).to(logits.dtype)
    rel = torch.cat([rel, torch.full((b, hw, num_heads, 1), NEG_INF,
                                     dtype=rel.dtype, device=rel.device)],
                    dim=-1).transpose(1, 2)                    # [b,h,q,w2+1]
    bias = torch.gather(rel, -1, omap.expand(b, num_heads, hw, hw))
    logits = torch.clamp(logits + bias, min=NEG_INF)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    out = torch.matmul(probs.to(v.dtype), vh)                  # [b,h,q,dv]
    return out.transpose(1, 2).reshape(b, hw, num_heads * dv)


def interleave_heads(x1: torch.Tensor, x2: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """Per-head concat of two half-value streams."""
    b, l, c = x1.shape
    if num_heads == 1:
        return torch.cat([x1, x2], dim=-1)
    h1 = x1.reshape(b, l, num_heads, c // num_heads)
    h2 = x2.reshape(b, l, num_heads, c // num_heads)
    return torch.cat([h1, h2], dim=-1).reshape(b, l, 2 * c)

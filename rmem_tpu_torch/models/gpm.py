"""Dual-branch Gated Propagation Module (DeAOT's decoupled transformer).

Counterpart of `rmem_tpu/models/gpm.py`. Two streams per layer: visual
`tgt` and identity `tgt_id` (from layer 0's output on). Memory entries are
(K, V ++ ID_V): long-term attention into the bank (kernel K1) and local
short-term attention (kernel K4) read the concatenated values jointly and
the output splits back into the two streams. Each attention is gated
(output * silu(U)), then a depthwise conv and a projection, in its
profiler span (`rmem.model.block.long`, `.short`, `.self`;
utils/trace.py). The gated
self-attention is plain PyTorch: it has no kernel.

In training mode (`module.train()`) both attentions go through the
differentiable wrappers instead: bank attention through K1 with lse and K2,
local attention through K5, and the slot temporal PE is added to the bank's
keys (the slab add of the JAX package's VJP path) rather than passed as the
inference kernel's logit bias.

Two opt-in inference routes, chosen by the engine and passed down as
arguments (`qminor`, `fused_dw`), as the JAX package's dispatch modes pass
them: bank attention through K3 (`bank_attention_qminor`) with the slot PE
added to the bank's keys as a slab, and every gated tail whose width is a
multiple of 128 through the fused gate-multiply + depthwise conv K8
(`gated_dwconv`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from rmem_tpu_torch.kernels import bank_attention as bank_kernel
from rmem_tpu_torch.kernels import dwconv as dw_kernel
from rmem_tpu_torch.kernels import local_attention as local_kernel
from rmem_tpu_torch.ops.attention import (interleave_heads,
                                          multihead_attention, slot_pe_bias)
from rmem_tpu_torch.ops.layers import DWConv2d, GroupNorm, LayerNorm, silu
from rmem_tpu_torch.utils.trace import span

MAX_LOCAL_DIS = 7  # window 15


class GatedTail(nn.Module):
    """Gate + depthwise conv + projection shared by the gated attentions."""

    def __init__(self, expand_dim: int, out_dim: int):
        super().__init__()
        self.dw_conv = DWConv2d(expand_dim)
        self.projection = nn.Linear(expand_dim, out_dim)

    def forward(self, agg, gate, size_2d, fused: bool = False):
        """With `fused`, a tail whose width is a multiple of 128 (as
        rmem_tpu/ops/layers.py:_DWKernel5x5 decides) runs the gate multiply
        and the depthwise conv as one kernel."""
        weight = self.dw_conv.conv.weight
        if fused and weight.shape[0] % 128 == 0:
            out = dw_kernel.gated_dwconv(agg.contiguous(), gate.contiguous(),
                                         weight, size_2d)
        else:
            out = self.dw_conv(agg * gate, size_2d)
        return self.projection(out)


class GatedSelfAttention(nn.Module):
    """Gated self-attention over the concatenated [vis, id] stream."""

    def __init__(self, d_vu: int, num_heads: int, d_att: int):
        super().__init__()
        self.num_heads = num_heads
        self.d_att = d_att
        din = d_vu // 2
        self.linear_QK = nn.Linear(d_vu, d_att * num_heads)
        self.linear_V1 = nn.Linear(din, d_vu)
        self.linear_V2 = nn.Linear(din, d_vu)
        self.linear_U1 = nn.Linear(din, d_vu)
        self.linear_U2 = nn.Linear(din, d_vu)
        self.tail = GatedTail(2 * d_vu, d_vu)

    def forward(self, x, size_2d, fused_dw: bool = False):
        qk = self.linear_QK(x)
        v1, v2 = x.chunk(2, dim=-1)
        v = silu(interleave_heads(self.linear_V1(v1), self.linear_V2(v2),
                                  self.num_heads))
        u = silu(interleave_heads(self.linear_U1(v1), self.linear_U2(v2),
                                  self.num_heads))
        agg = multihead_attention(qk, qk, v, self.num_heads,
                                  scale=self.d_att ** -0.5)
        return self.tail(agg, u, size_2d, fused=fused_dw)


class GPMBlock(nn.Module):
    """Long-term + local short-term gated attention, then gated
    self-attention. No FFN."""

    def __init__(self, d_model: int, self_heads: int, att_heads: int,
                 layer_idx: int, expand_ratio: float = 2.0):
        super().__init__()
        d = d_model
        self.layer_idx = layer_idx
        self.att_heads = att_heads
        self.expand_d = int(d * expand_ratio)
        self.d_att = d // 2 if att_heads == 1 else d // att_heads
        win2 = (2 * MAX_LOCAL_DIS + 1) ** 2
        dk = self.d_att * att_heads

        self.norm1 = LayerNorm(d)
        self.linear_QV = nn.Linear(d, dk + self.expand_d)
        self.linear_U = nn.Linear(d, self.expand_d)
        if layer_idx == 0:
            self.linear_ID_V = nn.Linear(d, self.expand_d)
        else:
            self.id_norm1 = LayerNorm(d)
            self.linear_ID_V = nn.Linear(2 * d, self.expand_d)
            self.linear_ID_U = nn.Linear(d, self.expand_d)
        self.long_tail = GatedTail(2 * self.expand_d, 2 * d)
        self.relative_emb_k = nn.Linear(dk, att_heads * win2)
        self.short_tail = GatedTail(2 * self.expand_d, 2 * d)
        self.norm2 = LayerNorm(d)
        self.id_norm2 = LayerNorm(d)
        self.self_attn = GatedSelfAttention(2 * d, self_heads, self.d_att)

    def fuse_id_value(self, curr_id_v, id_emb):
        """Layer 0 embeds the id alone; deeper layers fuse [id-stream
        features, id embedding]."""
        if self.layer_idx == 0:
            return silu(self.linear_ID_V(id_emb))
        return silu(self.linear_ID_V(torch.cat([curr_id_v, id_emb], dim=-1)))

    def forward(self, tgt, tgt_id, bank_k, bank_v, count, short_k, short_v,
                id_emb, cur_pe, slot_pe, size_2d, true_lk=None,
                qminor: bool = False, fused_dw: bool = False):
        """bank_k [S, B, HW, Ck] and bank_v [S, B, HW, Cv] (Cv = V ++ ID_V)
        with `count` valid slots (int32 tensor); short_k/short_v
        [B, HW, *]. With `id_emb` (the reference frame) the block attends to
        its own frame instead: one slot, and the short-term memory is the
        frame itself. `qminor` and `fused_dw` select the opt-in inference
        kernels K3 and K8. Returns (tgt, tgt_id, mems, record)."""
        dk = self.d_att * self.att_heads
        scale = self.d_att ** -0.5
        _tgt = self.norm1(tgt)
        qv = self.linear_QV(_tgt)
        curr_u = self.linear_U(_tgt)
        curr_q = curr_k = qv[..., :dk].contiguous()
        curr_v = silu(qv[..., dk:])

        if tgt_id is None:
            curr_id_v = None
            cat_u = torch.cat([silu(curr_u), torch.ones_like(curr_u)], dim=-1)
        else:
            curr_id_v = self.id_norm1(tgt_id)
            cat_u = silu(torch.cat([curr_u, self.linear_ID_U(curr_id_v)],
                                   dim=-1))

        if id_emb is not None:
            cat_v = torch.cat([curr_v, self.fuse_id_value(curr_id_v, id_emb)],
                              dim=-1)
            bank_k, bank_v = curr_k[None], cat_v[None]
            count = torch.ones((), dtype=torch.int32, device=tgt.device)
            short_k, short_v = curr_k, cat_v
            true_lk = None

        with span("rmem.model.block.long"):
            q_t = curr_q + cur_pe if cur_pe is not None else curr_q
            if slot_pe is not None and (self.training or qminor):
                bank_k = bank_k + slot_pe.to(bank_k.dtype)[:, None, None, :]
            if self.training:
                agg, record = bank_kernel.bank_attention_train(
                    q_t, bank_k, bank_v, count, scale,
                    num_heads=self.att_heads)
            elif qminor:
                agg, record = bank_kernel.bank_attention_qminor(
                    q_t, bank_k, bank_v, count, self.att_heads, scale)
            else:
                bias = (None if slot_pe is None else
                        slot_pe_bias(q_t, slot_pe, self.att_heads, scale))
                agg, record = bank_kernel.bank_attention_infer(
                    q_t, bank_k, bank_v, count, self.att_heads, scale,
                    true_lk=true_lk, qbias=bias)
            cat_tgt2 = self.long_tail(agg, cat_u, size_2d, fused=fused_dw)

        with span("rmem.model.block.short"):
            rel = self.relative_emb_k(curr_q)  # from the unscaled q
            local = (local_kernel.local_attention_trainable if self.training
                     else local_kernel.local_attention)
            agg3 = local(curr_q, short_k, short_v, rel, size_2d,
                         self.att_heads, MAX_LOCAL_DIS, scale)
            cat_tgt3 = self.short_tail(agg3, cat_u, size_2d, fused=fused_dw)

        tgt2, tgt_id2 = cat_tgt2.chunk(2, dim=-1)
        tgt3, tgt_id3 = cat_tgt3.chunk(2, dim=-1)
        tgt = tgt + tgt2 + tgt3
        tgt_id = (tgt_id2 + tgt_id3 if tgt_id is None
                  else tgt_id + tgt_id2 + tgt_id3)

        with span("rmem.model.block.self"):
            cat_in = torch.cat([self.norm2(tgt), self.id_norm2(tgt_id)],
                               dim=-1)
            tgt2, tgt_id2 = self.self_attn(cat_in, size_2d,
                                           fused_dw=fused_dw).chunk(2, dim=-1)
            tgt = tgt + tgt2
            tgt_id = tgt_id + tgt_id2

        mems = dict(curr_k=curr_k, curr_v=curr_v,
                    curr_id_v=(curr_id_v if curr_id_v is not None
                               else torch.zeros_like(tgt_id)))
        return tgt, tgt_id, mems, record


class GPM(nn.Module):
    """The DualBranchGPM stack."""

    def __init__(self, num_layers: int, d_model: int, self_heads: int = 1,
                 att_heads: int = 1, intermediate_norm: bool = False,
                 final_norm: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.intermediate_norm = intermediate_norm
        self.final_norm = final_norm
        for i in range(num_layers):
            setattr(self, f"block{i}",
                    GPMBlock(d_model, self_heads, att_heads, layer_idx=i))
        self.num_norms = ((num_layers - 1 if intermediate_norm else 0)
                          + int(final_norm))
        for i in range(self.num_norms):
            setattr(self, f"decoder_norm{i}", GroupNorm(2, 2 * d_model))

    def block(self, i: int) -> GPMBlock:
        return getattr(self, f"block{i}")

    def forward(self, tgt, bank: Optional[Tuple[torch.Tensor, torch.Tensor]],
                count, short, id_emb, cur_pe, slot_pe,
                size_2d: Tuple[int, int], qminor: bool = False,
                fused_dw: bool = False, self_pos=None, dp_gen=None):
        """bank: (k [L,S,B,HW,Ck], v [L,S,B,HW,Cv]) or None for the
        reference frame; short: (k [L,B,HW,Ck], v [L,B,HW,Cv]) or None;
        `qminor` and `fused_dw` go to every block; `self_pos` is unused, as
        in the JAX package's GPM; a drop-path generator `dp_gen` raises
        (the GPM's drop-path is not ported; the training step passes none).
        Returns (intermediates [L x (B,HW,2C)], mems, layer-0 record)."""
        if dp_gen is not None:
            raise NotImplementedError("the GPM's drop-path is not ported")
        out, out_id = tgt, None
        intermediates: List[torch.Tensor] = []
        mems_list: List[Dict[str, torch.Tensor]] = []
        record0 = None
        true_lk = size_2d[0] * size_2d[1]
        for i in range(self.num_layers):
            out, out_id, mems, rec = self.block(i)(
                out, out_id,
                bank[0][i] if bank is not None else None,
                bank[1][i] if bank is not None else None, count,
                short[0][i] if short is not None else None,
                short[1][i] if short is not None else None,
                id_emb, cur_pe, slot_pe, size_2d,
                true_lk=true_lk if bank is not None else None,
                qminor=qminor, fused_dw=fused_dw)
            if i == 0:
                record0 = rec
            intermediates.append(torch.cat([out, out_id], dim=-1))
            mems_list.append(mems)

        norm = lambda j, x: getattr(self, f"decoder_norm{j}")(
            x, channels_last=True)
        if self.final_norm:
            intermediates[-1] = norm(self.num_norms - 1, intermediates[-1])
        if self.intermediate_norm:
            for i in range(len(intermediates) - 1):
                intermediates[i] = norm(i, intermediates[i])
        mems = {k: torch.stack([m[k] for m in mems_list])
                for k in mems_list[0]}
        return intermediates, mems, record0

    def project_memories(self, mems: Dict[str, torch.Tensor], id_emb):
        """(long V, ID_V) to store: the id embedding fused into each layer's
        identity values."""
        id_vs = [self.block(i).fuse_id_value(mems["curr_id_v"][i], id_emb)
                 for i in range(self.num_layers)]
        return mems["curr_v"], torch.stack(id_vs)

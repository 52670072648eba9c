"""Long Short-Term Transformer: AOT's propagation stack.

Counterpart of `rmem_tpu/models/lstt.py`. Each block runs self-attention
over the frame (queries and keys carry the sine position embedding), then
long-term attention into the bank's valid slots with each slot's attention
mass, then short-term attention to the previous frame's entries, then a
conv FFN, each in its profiler span (`rmem.model.block.self`, `.long`,
`.short`, `.ffn`; utils/trace.py). The self-attention and the short-term attention are plain
PyTorch matmul + softmax: the JAX package computes them outside any Pallas
kernel.

The bank attention goes through `kernels/bank_attention.py`. In eval mode
it is `bank_attention_infer` (kernel K1ʰ at 8 heads of 32) with the slot
temporal PE as a factored logit bias. In training mode (`module.train()`)
the slot PE is added to the bank's keys as a slab, as the JAX package does
for its VJP kernel, and the call is the differentiable
`bank_attention_train` (K1'ʰ and K2ʰ at 8 heads of 32). Given a
`torch.Generator`, each block applies drop-path after its self-attention
and its FFN in training mode; the training step passes none, as the JAX
step passes no dp_rng.

The forward returns the raw current keys and values; `project_memories`
applies the id-conditioned re-projections when the engine writes them, so
the reference frame and later frames share one path. Module and parameter
names follow the flax tree (`lstt.block0.linear_Q.weight`), so
utils/checkpoint.params_from_jax maps one onto the other by its fixed rule.

With `gru_memory` each block holds RMem's two ConvGRU cells (`memory_gru_k`
with a 2 x 2 kernel, `memory_gru_v` with 1 x 1), which `compress_evicted`
runs on an evicted slot's keys and values (models/conv_gru.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from rmem_tpu_torch.kernels import bank_attention as bank_kernel
from rmem_tpu_torch.models.conv_gru import ConvGRUCellOutput
from rmem_tpu_torch.ops.attention import multihead_attention, slot_pe_bias
from rmem_tpu_torch.ops.layers import GNActDWConv2d, LayerNorm, drop_path
from rmem_tpu_torch.utils.trace import span


class MultiheadAttentionModule(nn.Module):
    """Q, K and V projections, attention, and the output projection."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.linear_Q = nn.Linear(d_model, d_model)
        self.linear_K = nn.Linear(d_model, d_model)
        self.linear_V = nn.Linear(d_model, d_model)
        self.projection = nn.Linear(d_model, d_model)

    def forward(self, q, k, v):
        out = multihead_attention(self.linear_Q(q), self.linear_K(k),
                                  self.linear_V(v), self.num_heads)
        return self.projection(out)


class LSTTBlock(nn.Module):
    """Self-attention, long-term bank attention (+ slot temporal PE),
    short-term attention to the previous frame, conv FFN."""

    def __init__(self, d_model: int, self_heads: int, att_heads: int,
                 dim_feedforward: int, linear_q: bool = False,
                 droppath: float = 0.1, gru_memory: bool = False):
        super().__init__()
        d = d_model
        if gru_memory:
            self.memory_gru_k = ConvGRUCellOutput(d, d, kernel=2)
            self.memory_gru_v = ConvGRUCellOutput(d, d, kernel=1)
        self.att_heads = att_heads
        self.linear_q = linear_q
        self.droppath = droppath
        self.norm1 = LayerNorm(d)
        self.self_attn = MultiheadAttentionModule(d, self_heads)
        self.norm2 = LayerNorm(d)
        self.linear_Q = nn.Linear(d, d)
        self.linear_V = nn.Linear(d, d)
        self.linear_QMem = nn.Linear(d, d)
        self.linear_VMem = nn.Linear(d, d)
        if not linear_q:
            self.norm4 = LayerNorm(d)
        self.long_proj = nn.Linear(d, d)
        self.short_proj = nn.Linear(d, d)
        self.norm3 = LayerNorm(d)
        self.linear1 = nn.Linear(d, dim_feedforward)
        self.activation = GNActDWConv2d(dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d)

    def forward(self, tgt, bank_k, bank_v, count, short_k, short_v, id_emb,
                self_pos, cur_pe, slot_pe, size_2d, true_lk=None,
                dp_gen: Optional[torch.Generator] = None):
        """tgt [B, HW, C]; bank_k, bank_v [S, B, Lk, C] with `count` valid
        slots (int32 tensor) and keys >= true_lk masked (in eval mode; the
        training bank holds no padding); short_k, short_v [B, HW, C];
        self_pos [1, HW, C] or None; slot_pe [S, C] or None; dp_gen the
        drop-path generator or None. With `id_emb` (the reference frame)
        the block's memory is its own frame, id-conditioned: one slot, and
        the short-term memory too. Returns (tgt, mems, record [B, HW, S])."""
        with span("rmem.model.block.self"):
            _tgt = self.norm1(tgt)
            q = k = _tgt + self_pos if self_pos is not None else _tgt
            tgt = tgt + drop_path(self.self_attn(q, k, _tgt), self.droppath,
                                  dp_gen, self.training)

        _tgt = self.norm2(tgt)
        curr_q = curr_k = self.linear_Q(_tgt)
        curr_v = _tgt
        if id_emb is not None:
            gv = self.linear_V(curr_v + id_emb)
            bank_k, bank_v = curr_k[None], gv[None]
            count = torch.ones((), dtype=torch.int32, device=tgt.device)
            local_k, local_v = curr_k, gv
            true_lk = None
        else:
            local_k, local_v = short_k, short_v

        with span("rmem.model.block.long"):
            q_t = curr_q + cur_pe if cur_pe is not None else curr_q
            scale = (q_t.shape[-1] // self.att_heads) ** -0.5
            if self.training:
                if slot_pe is not None:
                    bank_k = (bank_k
                              + slot_pe.to(bank_k.dtype)[:, None, None, :])
                tgt2, record = bank_kernel.bank_attention_train(
                    q_t, bank_k, bank_v, count, scale,
                    num_heads=self.att_heads)
            else:
                bias = (None if slot_pe is None else
                        slot_pe_bias(q_t, slot_pe, self.att_heads, scale))
                tgt2, record = bank_kernel.bank_attention_infer(
                    q_t, bank_k, bank_v, count, self.att_heads, scale,
                    true_lk=true_lk, qbias=bias)
            tgt2 = self.long_proj(tgt2)

        with span("rmem.model.block.short"):
            if self.linear_q:
                sk = torch.cat([local_k, curr_k], dim=1)
                sv = torch.cat([local_v, curr_v], dim=1)
            else:
                sk = self.norm4(local_k + curr_k)
                sv = self.norm4(local_v + curr_v)
            tgt3 = self.short_proj(multihead_attention(curr_q, sk, sv,
                                                       self.att_heads))
        tgt = tgt + tgt2 + tgt3

        with span("rmem.model.block.ffn"):
            _tgt = self.norm3(tgt)
            tgt = tgt + drop_path(
                self.linear2(self.activation(self.linear1(_tgt), size_2d)),
                self.droppath, dp_gen, self.training)
        mems = dict(curr_k=curr_k, curr_v=curr_v,
                    short_k=self.linear_QMem(tgt3), short_v=tgt3)
        return tgt, mems, record

    def project_memories(self, curr_v, short_v, id_emb):
        """The id-conditioned values to store: (long_v, short_v)."""
        return (self.linear_V(curr_v + id_emb),
                self.linear_VMem(short_v + id_emb))

    def compress_slot(self, k_slot, v_slot, hid_k, hid_v,
                      size_2d: Tuple[int, int]):
        """An evicted slot's keys and values [B, HW, C] through the GRU
        cells with their hidden states [B, H, W, C]. Returns (out_k, out_v
        [B, HW, C], new hid_k, new hid_v)."""
        b, hw, c = k_slot.shape
        grid = (b, *size_2d, c)
        nhk, ok = self.memory_gru_k(k_slot.reshape(grid), hid_k)
        nhv, ov = self.memory_gru_v(v_slot.reshape(grid), hid_v)
        return ok.reshape(b, hw, c), ov.reshape(b, hw, c), nhk, nhv


class LSTT(nn.Module):
    """A stack of LSTTBlocks and the decoder's LayerNorms."""

    def __init__(self, num_layers: int, d_model: int, self_heads: int = 8,
                 att_heads: int = 8, dim_feedforward: int = 1024,
                 linear_q: bool = False, droppath: float = 0.1,
                 intermediate_norm: bool = True, final_norm: bool = True,
                 gru_memory: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.intermediate_norm = intermediate_norm
        self.final_norm = final_norm
        for i in range(num_layers):
            setattr(self, f"block{i}",
                    LSTTBlock(d_model, self_heads, att_heads,
                              dim_feedforward, linear_q, droppath,
                              gru_memory))
        self.num_norms = ((num_layers - 1 if intermediate_norm else 0)
                          + int(final_norm))
        for i in range(self.num_norms):
            setattr(self, f"decoder_norm{i}", LayerNorm(d_model))

    def block(self, i: int) -> LSTTBlock:
        return getattr(self, f"block{i}")

    def forward(self, tgt, bank: Optional[Tuple[torch.Tensor, torch.Tensor]],
                count, short, id_emb, cur_pe, slot_pe,
                size_2d: Tuple[int, int], qminor: bool = False,
                fused_dw: bool = False, self_pos=None,
                dp_gen: Optional[torch.Generator] = None):
        """bank: (k [L,S,B,HW,C], v [L,S,B,HW,C]) or None for the reference
        frame; short: (k [L,B,HW,C], v) or None; dp_gen the drop-path
        generator or None. The opt-in routes `qminor` and `fused_dw` do
        not apply: the JAX engine sends AOT through neither, and the LSTT
        has no gated tail. Returns (intermediates [L x (B,HW,C)], mems
        stacked [L, ...], layer-0 record)."""
        out = tgt
        intermediates: List[torch.Tensor] = []
        mems_list: List[Dict[str, torch.Tensor]] = []
        record0 = None
        true_lk = size_2d[0] * size_2d[1]
        for i in range(self.num_layers):
            out, mems, rec = self.block(i)(
                out,
                bank[0][i] if bank is not None else None,
                bank[1][i] if bank is not None else None, count,
                short[0][i] if short is not None else None,
                short[1][i] if short is not None else None,
                id_emb, self_pos, cur_pe, slot_pe, size_2d,
                true_lk=true_lk if bank is not None else None,
                dp_gen=dp_gen)
            if i == 0:
                record0 = rec
            intermediates.append(out)
            mems_list.append(mems)

        norm = lambda j, x: getattr(self, f"decoder_norm{j}")(x)
        if self.final_norm:
            intermediates[-1] = norm(self.num_norms - 1, intermediates[-1])
        if self.intermediate_norm:
            for i in range(len(intermediates) - 1):
                intermediates[i] = norm(i, intermediates[i])
        mems = {k: torch.stack([m[k] for m in mems_list])
                for k in mems_list[0]}
        return intermediates, mems, record0

    def project_memories(self, mems: Dict[str, torch.Tensor], id_emb):
        """Per layer (long_v, short_v) to store, each stacked [L, B, HW, C]."""
        pairs = [self.block(i).project_memories(mems["curr_v"][i],
                                                mems["short_v"][i], id_emb)
                 for i in range(self.num_layers)]
        return (torch.stack([p[0] for p in pairs]),
                torch.stack([p[1] for p in pairs]))

    def compress_evicted(self, k_slots, v_slots, hid_k, hid_v,
                         size_2d: Tuple[int, int]):
        """Each layer's evicted slot [L, B, HW, C] through its GRU cells,
        hidden states [L, B, H, W, C]. Returns (out_k, out_v, hid_k, hid_v),
        each stacked over the layers."""
        outs = [self.block(i).compress_slot(k_slots[i], v_slots[i], hid_k[i],
                                            hid_v[i], size_2d)
                for i in range(self.num_layers)]
        return tuple(torch.stack([o[j] for o in outs]) for j in range(4))

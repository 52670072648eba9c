"""DeAOT: AOT with the dual-branch GPM.

Counterpart of `rmem_tpu/models/deaot.py`: the decoder input doubles
(visual and id streams), the id embedding gets a LayerNorm, and the
temporal PE is as wide as the GPM's keys: C/2 with one head, C with
`no_memory_gap`'s two (the JAX package fixes it at C/2, which at two heads
does not broadcast against the keys: ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Dict

import torch

from rmem_tpu_torch.models.aot import AOT
from rmem_tpu_torch.models.gpm import GPM
from rmem_tpu_torch.ops.layers import LayerNorm


class DeAOT(AOT):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.id_norm = LayerNorm(cfg.model_encoder_embedding_dim)

    def _build_lstt(self):
        cfg = self.cfg
        return GPM(num_layers=cfg.model_lstt_num,
                   d_model=cfg.model_encoder_embedding_dim,
                   self_heads=cfg.model_self_heads,
                   att_heads=cfg.model_att_heads,
                   intermediate_norm=cfg.model_decoder_intermediate_lstt)

    def _decoder_indim(self) -> int:
        cfg = self.cfg
        c = cfg.model_encoder_embedding_dim
        if cfg.model_decoder_intermediate_lstt:
            return c * (cfg.model_lstt_num * 2 + 1)
        return c * 2

    def _temporal_pe_dim(self) -> int:
        """The GPM's key width, d_att x heads (GPMBlock's rule)."""
        c, heads = (self.cfg.model_encoder_embedding_dim,
                    self.cfg.model_att_heads)
        return c // 2 if heads == 1 else c // heads * heads

    def _id_post(self, e):
        return self.id_norm(e)

    def write_memories(self, mems: Dict[str, torch.Tensor], id_emb):
        """(long_k, long_v, short_k, short_v), each [L, B, HW, *]: V and
        ID_V are stored concatenated, as both attentions read them
        jointly, and the short-term memory shares the entries."""
        long_v, id_v = self.lstt.project_memories(mems, id_emb)
        cat_v = torch.cat([long_v, id_v], dim=-1)
        return mems["curr_k"], cat_v, mems["curr_k"], cat_v

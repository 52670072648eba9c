"""The AOT-family model: encoder, projector, identity bank, positional
embeddings, propagation stack (AOT's LSTT here; DeAOT overrides it with the
GPM) and FPN decoder, with the methods the inference engine calls.

Counterpart of `rmem_tpu/models/aot.py`. Module and parameter names follow
the flax tree (`encoder.layer1_0.conv1.weight` is the flax
`encoder/layer1_0/conv1/kernel`), so utils/checkpoint.params_from_jax maps
one onto the other by a fixed rule. Sequences are [B, HW, C]; feature maps
NCHW; logits channel-last [B, h, w, obj+1] as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from rmem_tpu_torch.config import Config
from rmem_tpu_torch.models.decoders import build_decoder
from rmem_tpu_torch.models.encoders import build_encoder
from rmem_tpu_torch.models.lstt import LSTT
from rmem_tpu_torch.ops.layers import conv, seq_to_map
from rmem_tpu_torch.ops.position import sine_position_embedding_on


class AOT(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        c = cfg.model_encoder_embedding_dim
        self.encoder = build_encoder(cfg.model_encoder)
        self.encoder_projector = conv(cfg.model_encoder_dim[-1], c, 1)
        self.lstt = self._build_lstt()
        self.decoder = build_decoder(
            "fpn", in_dim=self._decoder_indim(),
            out_dim=cfg.model_max_obj_num + 1,
            decode_intermediate_input=cfg.model_decoder_intermediate_lstt,
            hidden_dim=c, shortcut_dims=cfg.model_encoder_dim,
            align_corners=cfg.model_align_corners)
        # the k x k / stride-16 conv that embeds the one-hot (+ignore) mask
        k = 17 if cfg.model_align_corners else 16
        self.patch_wise_id_bank = nn.Conv2d(cfg.id_channels, c, k, stride=16,
                                            padding=8 if k == 17 else 0)
        if cfg.use_temporal_positional_embedding:
            pe_dim = self._temporal_pe_dim()
            slots = 4 if cfg.temporal_positional_embedding_slot_4 else 2
            self.cur_pos_emb = nn.Parameter(torch.zeros(1, pe_dim))
            self.mem_pos_emb = nn.Parameter(torch.zeros(slots, pe_dim))

    def _build_lstt(self) -> nn.Module:
        cfg = self.cfg
        return LSTT(num_layers=cfg.model_lstt_num,
                    d_model=cfg.model_encoder_embedding_dim,
                    self_heads=cfg.model_self_heads,
                    att_heads=cfg.model_att_heads,
                    linear_q=cfg.model_linear_q,
                    droppath=cfg.train_lstt_droppath,
                    intermediate_norm=cfg.model_decoder_intermediate_lstt,
                    gru_memory=cfg.gru_memory_active)

    def _decoder_indim(self) -> int:
        cfg = self.cfg
        if cfg.model_decoder_intermediate_lstt:
            return cfg.model_encoder_embedding_dim * (cfg.model_lstt_num + 1)
        return cfg.model_encoder_embedding_dim

    def _temporal_pe_dim(self) -> int:
        return self.cfg.model_encoder_embedding_dim

    def _id_post(self, e):
        return e

    # ---- engine-facing methods ----
    def encode_image(self, img: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """img [B,H,W,3] -> NCHW pyramid [4x, 8x, 16x, 16x-projected]."""
        return self.encode_image_aux(img)[0]

    def encode_image_aux(self, img: torch.Tensor):
        """(encode_image's pyramid, the encoder's var_loss): the top-down
        encoders return (pyramid, var_loss), var_loss in training mode
        only; for every other encoder it is None."""
        out = self.encoder(img)
        xs, var_loss = out if isinstance(out[0], tuple) else (out, None)
        xs = list(xs)
        xs[-1] = self.encoder_projector(xs[-1])
        return tuple(xs), var_loss

    def get_id_emb(self, label: torch.Tensor) -> torch.Tensor:
        """Int label plane [B,H,W] of channel indices (255 already mapped to
        the ignore channel obj+1) -> [B, HW, C] identity embedding. Indices
        outside [0, id_channels) embed as zero, like the conv's padding."""
        w = self.patch_wise_id_bank.weight
        ids = torch.arange(w.shape[1], device=label.device)
        onehot = (label[:, None] == ids[None, :, None, None]).to(w.dtype)
        e = self.patch_wise_id_bank(onehot)                  # [B, C, h, w]
        return self._id_post(e.flatten(2).transpose(1, 2))

    def get_pos_emb(self, h: int, w: int) -> torch.Tensor:
        """[1, HW, C] sine position embedding on the weights' device, in
        their dtype."""
        weight = self.encoder_projector.weight
        return sine_position_embedding_on(
            h, w, self.cfg.model_encoder_embedding_dim, weight.device,
            weight.dtype)

    def temporal_pe(self):
        if not self.cfg.use_temporal_positional_embedding:
            return None, None
        return self.cur_pos_emb, self.mem_pos_emb

    def lstt_forward(self, feat, bank, count, short, id_emb, cur_pe, slot_pe,
                     size_2d: Tuple[int, int], qminor: bool = False,
                     fused_dw: bool = False, self_pos=None, dp_gen=None):
        """The propagation stack; `dp_gen` (a torch.Generator or None) is
        its drop-path generator."""
        return self.lstt(feat, bank, count, short, id_emb, cur_pe, slot_pe,
                         size_2d, qminor=qminor, fused_dw=fused_dw,
                         self_pos=self_pos, dp_gen=dp_gen)

    def write_memories(self, mems: Dict[str, torch.Tensor], id_emb):
        """(long_k, long_v, short_k, short_v), each [L, B, HW, C]: the
        values id-conditioned and re-projected."""
        long_v, short_v = self.lstt.project_memories(mems, id_emb)
        return mems["curr_k"], long_v, mems["short_k"], short_v

    def decode_id_logits(self, intermediates: Sequence[torch.Tensor],
                         shortcuts: Sequence[torch.Tensor]) -> torch.Tensor:
        """-> f32 logits [B, H/4, W/4, obj+1], channel-last."""
        h, w = shortcuts[-1].shape[2:]
        inputs = [shortcuts[-1]] + [seq_to_map(e, (h, w))
                                    for e in intermediates]
        return self.decoder(inputs, shortcuts).permute(0, 2, 3, 1)

"""Config for the PyTorch port: the model and stage presets of R50-DeAOTL +
RMem and R50-AOTL + RMem, inference and training, as one dataclass.

A copy of the fields of `rmem_tpu/config.py` that the port reads, with the
same names and defaults, so that one preset name gives the same model on
both sides. The port has one path per device, the CUDA kernels on the card
and their plain versions on the CPU, so of the JAX package's kernel
switches two opt-ins remain, both for inference and both off by default, as
there:

- `use_pallas_dwconv` routes every gated tail whose width is a multiple of
  128 through the fused gate-multiply + depthwise 5x5 kernel (K8,
  kernels/dwconv.py) instead of the multiply and the grouped conv;
- the environment variable `RMEM_BANK_QMINOR`, when set to a non-empty
  value, routes every inference bank-attention call through the slot-split
  kernel (K3, kernels/bank_attention.py:bank_attention_qminor), with the
  slot temporal PE added to the bank's keys instead of the logit bias.

The inference engine reads both once, when it is built.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


@dataclass
class Config:
    # ---- model architecture ----
    model_vos: str = "aot"                    # 'aot' | 'deaot'
    model_align_corners: bool = True
    model_encoder: str = "mobilenetv2"
    model_encoder_dim: Tuple[int, ...] = (24, 32, 96, 1280)  # 4x, 8x, 16x, 16x
    model_encoder_embedding_dim: int = 256
    model_decoder_intermediate_lstt: bool = True
    model_max_obj_num: int = 10
    model_ignore_token: bool = True
    model_self_heads: int = 8
    model_att_heads: int = 8
    model_lstt_num: int = 3
    # AOT's LSTT: the short-term memory is the previous frame's entries
    # concatenated with the current ones (True) or their sum through norm4
    model_linear_q: bool = False

    # ---- RMem knobs ----
    former_mem_len: int = 1
    latter_mem_len: int = 8
    use_temporal_positional_embedding: bool = True
    temporal_positional_embedding_slot_4: bool = True
    no_long_memory: bool = False
    # DeAOT's and AOT's NO_MEMORY_GAP (the reference's
    # configs/models/r50_deaotl.py:26-27): 2 attention heads and a
    # long-term write every training frame (get_config applies both); the
    # serving gap is the evaluator's rule divided by 4
    no_memory_gap: bool = False

    # ---- memory cadence: frames between long-term writes ----
    train_long_term_mem_gap: int = 9999
    test_long_term_mem_gap: int = 9999

    # ---- data ----
    data_randomcrop: Tuple[int, int] = (465, 465)
    data_seq_len: int = 5

    # ---- train ----
    train_total_steps: int = 100_000
    train_start_step: int = 0
    train_weight_decay: float = 0.07
    train_weight_decay_exemption: Tuple[str, ...] = (
        "absolute_pos_embed", "relative_position_bias_table",
        "relative_emb_v", "conv_out",
    )
    train_lr: float = 2e-4
    train_lr_min: float = 1e-5
    train_lr_power: float = 0.9
    train_lr_encoder_ratio: float = 0.1
    train_lr_warm_up_ratio: float = 0.05
    train_lr_cosine_decay: bool = False
    train_lr_restart: int = 1
    train_aux_loss_weight: float = 1.0
    train_aux_loss_ratio: float = 1.0
    train_batch_size: int = 16
    train_log_step: int = 20
    train_top_k_percent_pixels: float = 0.15
    train_seq_training_start_ratio: float = 0.5
    train_hard_mining_ratio: float = 0.5
    train_ema_ratio: float = 0.1
    train_clip_grad_norm: float = 5.0
    train_encoder_freeze_at: int = 2
    # the LSTT's stochastic depth rate; the training step passes no
    # generator, as the JAX step passes no dp_rng, so it stays the identity
    train_lstt_droppath: float = 0.1
    # per-frame recompute in the backward: "full" or "dots" checkpoints each
    # frame of the clip (the port has no policy that keeps matmul outputs,
    # so "dots" is "full" here); "none" keeps every activation
    train_remat: str = "dots"
    # branches of the JAX training step the port does not take: each must
    # stay off (the trainer raises NotImplementedError otherwise)
    reverse_infer: bool = False
    gru_memory: bool = False
    var_loss_weight: float = 0.0

    # ---- evaluation: augmentations and frame prep ----
    test_flip: bool = False
    test_multiscale: Tuple[float, ...] = (1.0,)
    test_min_size: Optional[int] = None
    test_max_size: float = 800 * 1.3
    # the gated tails through the fused kernel K8 (inference only)
    use_pallas_dwconv: bool = False

    # ---- numerics ----
    # activations on the card (autocast in training, where the parameters
    # stay f32); "float32" everywhere on the CPU tests
    compute_dtype: str = "bfloat16"

    @property
    def max_mem_slots(self) -> int:
        """Bank capacity: former + latter, plus one spare slot that takes the
        write of frames that store nothing."""
        return self.former_mem_len + self.latter_mem_len + 1

    @property
    def id_channels(self) -> int:
        return self.model_max_obj_num + (2 if self.model_ignore_token else 1)

    @property
    def gru_memory_active(self) -> bool:
        """The ConvGRU memory exists on the AOT path only: DeAOT ignores
        the flag, as in the JAX package."""
        return self.gru_memory and self.model_vos == "aot"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


MODEL_PRESETS: Dict[str, Dict[str, Any]] = {
    # CI-only tiny variant: the full AOT graph (8 heads of 8) on a toy encoder
    "tiny_aotl": dict(model_vos="aot", model_encoder="tiny",
                      model_encoder_dim=(32, 48, 64, 64),
                      model_encoder_embedding_dim=64, model_lstt_num=2,
                      train_long_term_mem_gap=2, test_long_term_mem_gap=2),
    # ResNet-50 OS16, 3 LSTT layers at d 256 with 8 heads of 32
    "r50_aotl": dict(model_vos="aot", model_encoder="resnet50",
                     model_encoder_dim=(256, 512, 1024, 1024),
                     model_lstt_num=3, train_long_term_mem_gap=2,
                     test_long_term_mem_gap=5),
    # CI-only tiny variant: the full DeAOT graph on a toy encoder
    "tiny_deaotl": dict(model_vos="deaot", model_encoder="tiny",
                        model_encoder_dim=(32, 48, 64, 64),
                        model_encoder_embedding_dim=64,
                        model_self_heads=1, model_att_heads=1,
                        model_decoder_intermediate_lstt=False,
                        model_lstt_num=2, train_long_term_mem_gap=2,
                        test_long_term_mem_gap=2),
    "r50_deaotl": dict(model_vos="deaot", model_encoder="resnet50",
                       model_encoder_dim=(256, 512, 1024, 1024),
                       model_self_heads=1, model_att_heads=1,
                       model_decoder_intermediate_lstt=False,
                       model_lstt_num=3, train_long_term_mem_gap=2,
                       test_long_term_mem_gap=5),
}

# the stage presets' fields that the port reads
STAGE_PRESETS: Dict[str, Dict[str, Any]] = {
    "default": {},
    "pre_vost": dict(train_total_steps=20_000, data_seq_len=15,
                     train_long_term_mem_gap=4, model_linear_q=False,
                     model_ignore_token=True),
    # pre_vost with clips of 17 frames: the training CLI's default stage
    "pre_vost_2": dict(train_total_steps=20_000, data_seq_len=17,
                       train_long_term_mem_gap=4, model_linear_q=False,
                       model_ignore_token=True),
    # pre_vost with clips of 25 frames
    "pre_vost_25q": dict(train_total_steps=20_000, data_seq_len=25,
                         train_long_term_mem_gap=4, model_linear_q=False,
                         model_ignore_token=True),
    # synthetic smoke stage: small crops, short clips
    "test": dict(train_total_steps=100, data_seq_len=3, train_batch_size=2,
                 data_randomcrop=(129, 129)),
}


def get_config(stage: str = "default", model: str = "r50_deaotl",
               **overrides) -> Config:
    """Compose model preset + stage preset + explicit overrides."""
    if model not in MODEL_PRESETS:
        raise ValueError(f"unknown model {model!r}; have {list(MODEL_PRESETS)}")
    if stage not in STAGE_PRESETS:
        raise ValueError(f"unknown stage {stage!r}; have {list(STAGE_PRESETS)}")
    kw = {**MODEL_PRESETS[model], **STAGE_PRESETS[stage], **overrides}
    if kw.get("no_memory_gap"):
        # as rmem_tpu/config.py:get_config. It also divides reverse_loss by
        # 4: the port has no such field and raises on reverse_infer, so the
        # division has nothing to act on yet
        kw["model_att_heads"] = 2
        kw["train_long_term_mem_gap"] = 1
    return Config(**kw)

"""Config for the PyTorch port: the model and stage presets of R50-DeAOTL +
RMem inference, as one dataclass.

A copy of the fields of `rmem_tpu/config.py` that the port reads, with the
same names and defaults, so that one preset name gives the same model on
both sides. The TPU-only kernel switches (`use_pallas_*`) are gone: the port
has one path per device, the CUDA kernels on the card and their plain
versions on the CPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple


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

    # ---- RMem knobs ----
    former_mem_len: int = 1
    latter_mem_len: int = 8
    use_temporal_positional_embedding: bool = True
    temporal_positional_embedding_slot_4: bool = True
    no_long_memory: bool = False

    # ---- memory cadence: frames between long-term writes ----
    test_long_term_mem_gap: int = 9999

    # ---- numerics ----
    compute_dtype: str = "bfloat16"   # activations and weights in the engine

    @property
    def max_mem_slots(self) -> int:
        """Bank capacity: former + latter, plus one spare slot that takes the
        write of frames that store nothing."""
        return self.former_mem_len + self.latter_mem_len + 1

    @property
    def id_channels(self) -> int:
        return self.model_max_obj_num + (2 if self.model_ignore_token else 1)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


MODEL_PRESETS: Dict[str, Dict[str, Any]] = {
    # CI-only tiny variant: the full DeAOT graph on a toy encoder
    "tiny_deaotl": dict(model_vos="deaot", model_encoder="tiny",
                        model_encoder_dim=(32, 48, 64, 64),
                        model_encoder_embedding_dim=64,
                        model_self_heads=1, model_att_heads=1,
                        model_decoder_intermediate_lstt=False,
                        model_lstt_num=2, test_long_term_mem_gap=2),
    "r50_deaotl": dict(model_vos="deaot", model_encoder="resnet50",
                       model_encoder_dim=(256, 512, 1024, 1024),
                       model_self_heads=1, model_att_heads=1,
                       model_decoder_intermediate_lstt=False,
                       model_lstt_num=3, test_long_term_mem_gap=5),
}

# the stage presets' fields that inference reads
STAGE_PRESETS: Dict[str, Dict[str, Any]] = {
    "default": {},
    "pre_vost": dict(model_ignore_token=True),
}


def get_config(stage: str = "default", model: str = "r50_deaotl",
               **overrides) -> Config:
    """Compose model preset + stage preset + explicit overrides."""
    if model not in MODEL_PRESETS:
        raise ValueError(f"unknown model {model!r}; have {list(MODEL_PRESETS)}")
    if stage not in STAGE_PRESETS:
        raise ValueError(f"unknown stage {stage!r}; have {list(STAGE_PRESETS)}")
    return Config(**{**MODEL_PRESETS[model], **STAGE_PRESETS[stage],
                     **overrides})

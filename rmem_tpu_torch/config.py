"""Config for the PyTorch port: the model presets of the AOT and DeAOT
families with RMem (on MobileNetV2, the default encoder, and on ResNet-50,
ResNet-101, MobileNetV3, ResNeSt-101, Swin-B and the top-down ResNet-50)
and the stage presets, inference and training, as one dataclass.

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

The evaluator's fields (`test_*`, `eval_*`) and the run's identity and
directories (`exp_name`, `stage_name`, `model_name`, `dir_*`) are the JAX
package's, with its defaults; `save` and `load` write and read the config
as JSON beside the run's results.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


@dataclass
class Config:
    # ---- identity: the result directory is
    # dir_root/<exp_name>_<model_name>/<stage_name> ----
    exp_name: str = "default"
    stage_name: str = "default"
    model_name: str = "AOTDefault"

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

    # ---- data: the training clips (data/train_datasets.py). As in the
    # JAX package, the loader reads neither data_random_reverse_seq (every
    # clip may be reversed), data_max_crop_steps (10 crop draws) nor
    # data_visor_repeat ----
    datasets: Tuple[str, ...] = ("youtubevos",)
    data_workers: int = 8
    data_randomcrop: Tuple[int, int] = (465, 465)
    data_randomflip: float = 0.5
    data_max_crop_steps: int = 10
    data_short_edge_len: int = 480
    data_min_scale_factor: float = 0.7
    data_max_scale_factor: float = 1.3
    data_random_reverse_seq: bool = True
    data_seq_len: int = 5
    data_davis_repeat: int = 5
    data_vost_repeat: int = 1
    data_vost_ignore_thresh: float = 0.2
    data_random_gap_davis: int = 12
    data_random_gap_ytb: int = 3
    data_random_gap_vost: int = 3
    data_random_gap_visor: int = 1
    data_visor_repeat: int = 1
    data_visor_ignore_thresh: float = 0.2
    data_dynamic_merge_prob: float = 0.2
    ignore_in_merge: bool = True

    # ---- pretrain / resume: the Trainer starts from pretrain_model (a
    # reference .pth or a JAX msgpack params tree) when pretrain is set ----
    pretrain: bool = True
    pretrain_model: str = ""

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
    # "adamw", or "sgd": momentum m = g + train_sgd_momentum * m, no
    # dampening and no Nesterov (optax.trace)
    train_opt: str = "adamw"
    train_sgd_momentum: float = 0.9
    train_batch_size: int = 16
    train_log_step: int = 20
    # every N steps the last frame of the batch's first clip, its labels
    # and the prediction go to dir_result/img_logs as PNGs; 0 is off
    train_tblog_step: int = 0
    train_top_k_percent_pixels: float = 0.15
    train_seq_training_start_ratio: float = 0.5
    train_hard_mining_ratio: float = 0.5
    train_ema_ratio: float = 0.1
    train_clip_grad_norm: float = 5.0
    # the checkpoint stream: params and EMA saved every train_save_step
    # steps under dir_result/ckpt and dir_result/ema_ckpt, the newest
    # train_max_keep_ckpt kept, and a new Trainer resumes from the newest
    # readable save when train_auto_resume is set
    train_save_step: int = 500
    train_max_keep_ckpt: int = 8
    train_auto_resume: bool = True
    train_encoder_freeze_at: int = 2
    # the LSTT's stochastic depth rate; the training step passes no
    # generator, as the JAX step passes no dp_rng, so it stays the identity
    train_lstt_droppath: float = 0.1
    # per-frame recompute in the backward: "full" or "dots" checkpoints each
    # frame of the clip (the port has no policy that keeps matmul outputs,
    # so "dots" is "full" here); "none" keeps every activation
    train_remat: str = "dots"
    # RMem's variants: re-decode frame 0 from the bank less its first
    # slot after every long-term write and add reverse_loss times its loss
    # (training only); compress each evicted slot into slot 1 through a
    # ConvGRU a layer (AOT only, served and trained: gru_memory_active)
    reverse_infer: bool = False
    reverse_loss: float = 0.4
    gru_memory: bool = False
    # the top-down encoder's reconstruction loss weight
    var_loss_weight: float = 0.0

    # ---- evaluation: dataset, weights, augmentations and frame prep ----
    test_dataset: str = "youtubevos"
    test_dataset_split: str = "val"
    # None or "test": random weights from init_params(model, 42); else a
    # checkpoint file (see models.load_model_params)
    test_ckpt_path: Optional[str] = None
    test_ckpt_step: Optional[int] = None
    # evaluate the checkpoint's EMA weights (else its trained weights)
    test_ema: bool = True
    test_flip: bool = False
    test_multiscale: Tuple[float, ...] = (1.0,)
    test_min_size: Optional[int] = None
    test_max_size: float = 800 * 1.3
    test_workers: int = 4
    # frames per engine call on unlabelled stretches of a video; the last
    # chunk of a video is padded with repeats of its final frame
    eval_scan_chunk: int = 16
    # >0: frames/s of every window of this many frames inside a video
    eval_fps_window: int = 0
    # frames reach the engine as uint8 and are resized and normalised on
    # its device; float frames (the synthetic dataset's) are always
    # prepared there too, from their float values
    eval_device_prep: bool = True
    # the JAX package's lossy YUV 4:2:0 upload: not ported (the evaluator
    # raises), as frames are decoded on the card and nothing is uploaded
    eval_yuv420_upload: bool = False
    # the gated tails through the fused kernel K8 (inference only)
    use_pallas_dwconv: bool = False

    # ---- numerics ----
    # activations on the card (autocast in training, where the parameters
    # stay f32); "float32" everywhere on the CPU tests
    compute_dtype: str = "bfloat16"

    # ---- processes (parallel/mesh.py): one process a card, the sizes of
    # the mesh's axes (-1 takes the processes left); "data" splits the
    # batch, "model" the GPM self-attention (parallel/tp.py) ----
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("data",)

    # ---- directories ----
    dir_root: str = "./results"
    dir_data: str = "./datasets"

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

    @property
    def dir_result(self) -> str:
        return os.path.join(self.dir_root,
                            f"{self.exp_name}_{self.model_name}",
                            self.stage_name)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def save(self, path: Optional[str] = None) -> str:
        """Write the config as JSON (default: dir_result/config.json)."""
        path = path or os.path.join(self.dir_result, "config.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=str)
        return path

    @staticmethod
    def load(path: str) -> "Config":
        """Read `save`'s JSON (or the JAX package's: keys this Config lacks
        are dropped), lists back to tuples."""
        with open(path) as f:
            d = json.load(f)
        names = {f.name for f in dataclasses.fields(Config)}
        return Config(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in d.items() if k in names})


def _r50_common(**kw) -> Dict[str, Any]:
    """The ResNet-50 presets' shared fields, as the JAX package's."""
    return dict(dict(model_encoder="resnet50",
                     model_encoder_dim=(256, 512, 1024, 1024),
                     model_lstt_num=3, train_long_term_mem_gap=2,
                     test_long_term_mem_gap=5), **kw)


MODEL_PRESETS: Dict[str, Dict[str, Any]] = {
    # the AOT family on the default encoder, MobileNetV2 (24, 32, 96, 1280)
    "aott": dict(model_vos="aot", model_lstt_num=1),
    "aots": dict(model_vos="aot", model_lstt_num=2),
    "aotb": dict(model_vos="aot", model_lstt_num=3),
    "aotl": dict(model_vos="aot", model_lstt_num=3,
                 train_long_term_mem_gap=2, test_long_term_mem_gap=5),
    # the feedback encoder and its reconstruction loss at weight 0.01
    "r50_topdown_aotl": _r50_common(model_vos="aot",
                                    model_encoder="resnet50_topdown",
                                    var_loss_weight=0.01),
    "aotl_v3": dict(model_vos="aot", model_encoder="mobilenetv3",
                    model_encoder_dim=(24, 40, 112, 960), model_lstt_num=3,
                    train_long_term_mem_gap=2, test_long_term_mem_gap=5),
    "swinb_aotl": _r50_common(model_vos="aot", model_encoder="swin_base",
                              model_encoder_dim=(128, 256, 512, 512)),
    # DeAOT-T: one GPM layer at one head, no intermediate decoding
    "deaott": dict(model_vos="deaot", model_lstt_num=1, model_self_heads=1,
                   model_att_heads=1, model_decoder_intermediate_lstt=False),
    # fixed model names, without the RMem flags' suffixes; ResNeSt-101 keeps
    # R101_AOTL too, as the reference's preset does
    "r101_aotl": _r50_common(model_vos="aot", model_encoder="resnet101",
                             model_name="R101_AOTL"),
    "rs101_aotl": _r50_common(model_vos="aot", model_encoder="resnest101",
                              model_name="R101_AOTL"),
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

# the stage presets' fields that the port reads: every preset of the JAX
# package
STAGE_PRESETS: Dict[str, Dict[str, Any]] = {
    "default": {},
    # static-image pretraining: one image jittered into a clip of 5
    "pre": dict(datasets=("static",), data_seq_len=5,
                train_total_steps=100_000),
    # YouTube-VOS and DAVIS 2017 together, clips of 5
    "pre_ytb_dav": dict(datasets=("youtubevos", "davis2017"),
                        data_seq_len=5),
    "ytb": dict(datasets=("youtubevos",), data_seq_len=5),
    # YouTube-VOS from the static-image stage: clips of 10, a write every
    # 4 frames, the short-term memory concatenated (model_linear_q)
    "pre_ytb": dict(datasets=("youtubevos",), data_seq_len=10,
                    train_long_term_mem_gap=4, train_total_steps=80_000,
                    model_linear_q=True),
    "pre_dav": dict(datasets=("davis2017",), train_total_steps=50_000),
    "pre_vost": dict(datasets=("vost",), train_total_steps=20_000,
                     data_seq_len=15, train_long_term_mem_gap=4,
                     model_linear_q=False, model_ignore_token=True,
                     train_auto_resume=False),
    # pre_vost with clips of 17 frames: the training CLI's default stage
    "pre_vost_2": dict(datasets=("vost",), train_total_steps=20_000,
                       data_seq_len=17, train_long_term_mem_gap=4,
                       model_linear_q=False, model_ignore_token=True,
                       train_auto_resume=False),
    # pre_vost with clips of 25 frames
    "pre_vost_25q": dict(datasets=("vost",), train_total_steps=20_000,
                         data_seq_len=25, train_long_term_mem_gap=4,
                         model_linear_q=False, model_ignore_token=True,
                         train_auto_resume=False),
    # smoke stage: constant synthetic clips, small crops, short clips
    "test": dict(datasets=("test",), train_total_steps=100, data_seq_len=3,
                 train_batch_size=2, pretrain=False, train_auto_resume=False,
                 data_randomcrop=(129, 129)),
}


def _rmem_name(base: str, kw: Dict[str, Any]) -> str:
    """MODEL_NAME from the RMem flags, as rmem_tpu/config.py:_rmem_name
    (the port has no time_encode, which adds nothing when off)."""
    name = base
    if kw.get("no_long_memory"):
        name += "_No_long_mem"
    if kw.get("no_memory_gap"):
        name += "_No_mem_gap"
    if kw.get("use_temporal_positional_embedding", True):
        name += "_Temp_pe"
        if kw.get("temporal_positional_embedding_slot_4", True):
            name += "_Slot_4"
    return name


def get_config(stage: str = "default", exp_name: str = "default",
               model: str = "r50_deaotl", **overrides) -> Config:
    """Compose model preset + stage preset + explicit overrides."""
    if model not in MODEL_PRESETS:
        raise ValueError(f"unknown model {model!r}; have {list(MODEL_PRESETS)}")
    if stage not in STAGE_PRESETS:
        raise ValueError(f"unknown stage {stage!r}; have {list(STAGE_PRESETS)}")
    kw = {**MODEL_PRESETS[model], **STAGE_PRESETS[stage], **overrides}
    base = {"aot": "AOTL", "deaot": "DeAOTL"}[kw.get("model_vos", "aot")]
    if kw.get("model_encoder", "mobilenetv2") == "resnet50":
        base = "R50_" + base
    kw.setdefault("model_name", _rmem_name(base, kw))
    kw.setdefault("exp_name", exp_name)
    kw.setdefault("stage_name", stage)
    if kw.get("no_memory_gap"):
        # as rmem_tpu/config.py:get_config: 2 heads, a write every
        # training frame, and a quarter of the reverse loss, as the
        # reference's r50_aotl.py and r50_deaotl.py divide it
        kw["model_att_heads"] = 2
        kw["train_long_term_mem_gap"] = 1
        kw["reverse_loss"] = kw.get("reverse_loss", 0.4) / 4
    return Config(**kw)

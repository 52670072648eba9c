"""Tiny stand-ins of the benchmark's cells for the CPU tests: the same
run kinds, traffic and check on the package's tiny presets in f32."""

from __future__ import annotations

import copy

from vosbench import harness


def serve_cell(model: str = "tiny_deaotl"):
    from rmem_tpu_torch.config import get_config
    wl = copy.deepcopy(harness.cell("aotl-serve-msflip"))
    wl.update(video={"raw_hw": [96, 160], "objects": 12, "frames": 40},
              augs=[[97, 161, False], [97, 161, True], [129, 209, False],
                    [129, 209, True]],
              chunk=4, gap=2, fill_frames=16, trace_units=1)
    cfg = get_config("pre_vost_2", model=model, compute_dtype="float32")
    return wl, cfg


def train_cell(model: str = "tiny_deaotl"):
    from rmem_tpu_torch.config import get_config
    wl = copy.deepcopy(harness.cell("deaotl-train-vost"))
    wl.update(clips={"clips": 6, "max_objects": 10}, warm_steps=2,
              trace_units=1)
    cfg = get_config("pre_vost_2", model=model, compute_dtype="float32",
                     train_batch_size=2, data_seq_len=6,
                     data_randomcrop=(65, 65), train_long_term_mem_gap=1,
                     latter_mem_len=3)
    return wl, cfg

"""The training step's share of the card's bf16 peak: the model FLOPs of a
step (forward and backward of every clip, no recompute, counted on the
plain reference on the meta device) times the timed window's steps/s,
over 989 TFLOP/s. Layer: the model step and engine/training.py. Moves
train_clips_per_s."""

import dataclasses

from vosbench.counts import PEAK_BF16_FLOPS
from vosbench.counts.model_flops import train_flops

UNIT = "%"


def read(ctx):
    if ctx["kind"] != "train" or not ctx["window"]["steps"]:
        return None
    cfg = ctx["cfg"]
    flops = train_flops(dataclasses.asdict(cfg), cfg.train_batch_size,
                        cfg.data_seq_len, tuple(cfg.data_randomcrop))
    rate = ctx["window"]["steps"] / ctx["window"]["seconds"]
    return 100.0 * flops * rate / PEAK_BF16_FLOPS

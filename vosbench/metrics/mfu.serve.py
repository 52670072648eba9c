"""The served step's share of the card's bf16 peak: the model FLOPs of a
frame (every aug's encoder, propagation over a full bank, decoder and
memory write, counted on the plain reference on the meta device) times the
timed window's frames/s, over 989 TFLOP/s. Layer: the model step
(models/aot.py, models/deaot.py). Moves serve_fps."""

import dataclasses

from vosbench.counts import PEAK_BF16_FLOPS
from vosbench.counts.model_flops import serve_flops

UNIT = "%"


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["window"]["frames"]:
        return None
    wl, cfg = ctx["wl"], ctx["cfg"]
    groups = -(-wl["video"]["objects"] // cfg.model_max_obj_num)
    flops = serve_flops(dataclasses.asdict(cfg),
                        [tuple(a[:2]) for a in wl["augs"]], groups)
    rate = ctx["window"]["frames"] / ctx["window"]["seconds"]
    return 100.0 * flops * rate / PEAK_BF16_FLOPS

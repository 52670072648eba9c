"""The runtime launches a served frame: those inside the program's span
`rmem.engine.chunk` (one `scan_steps_multi_raw` call) in the unit traced
with the host's spans, over the chunk's frames. Fixed by the code, so a
change that removes launches (a CUDA graph of the step) shows whatever the
host's speed. Layer: the engine (engine/inference.py). Moves serve_fps."""

from vosbench.spans import CHUNK, launches

UNIT = "launches"


def read(ctx):
    return launches(ctx, CHUNK, "serve")

"""The propagation stack's device milliseconds a served frame: the device
time of the kernels launched inside the program's span
`rmem.model.propagation` (every aug's LSTT or GPM layers, bank attention
included), in the unit traced with the host's spans, over its frames.
Layer: the model step (models/lstt.py, models/gpm.py). Moves serve_fps."""

from vosbench.spans import device_ms

UNIT = "ms"


def read(ctx):
    return device_ms(ctx, "rmem.model.propagation", "serve")

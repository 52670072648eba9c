"""The encoder's device milliseconds a served frame: the device time of the
kernels launched inside the program's span `rmem.model.encode` (every aug's
encoder pass), in the unit traced with the host's spans, over its frames.
Layer: the model step (models/encoders/, InferenceEngine._encode). Moves
serve_fps."""

from vosbench.spans import device_ms

UNIT = "ms"


def read(ctx):
    return device_ms(ctx, "rmem.model.encode", "serve")

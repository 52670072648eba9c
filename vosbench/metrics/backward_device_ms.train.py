"""The backward's device milliseconds a training step: the device time of
the kernels launched inside the program's span `rmem.train.backward`
(autograd's backward, the checkpointed frames' recomputation included), in
the unit traced with the host's spans, over its steps. Layer: the model
step (the kernels' backward wrappers, engine/training.py's checkpointed
frames). Moves train_clips_per_s."""

from vosbench.spans import device_ms

UNIT = "ms"


def read(ctx):
    return device_ms(ctx, "rmem.train.backward", "train")

"""The optimizer's runtime launches a training step: those inside the
program's span `rmem.train.optimizer` (`apply_gradients`: the clip, Adam,
weight decay and the EMA over every parameter tensor) in the unit traced
with the host's spans, over its steps. Fixed by the code: a change that
moves the optimizer off its per-parameter loop shows here whatever the
host's speed. Layer: the trainer (engine/train_state.py). Moves
train_clips_per_s."""

from vosbench.spans import launches

UNIT = "launches"


def read(ctx):
    return launches(ctx, "rmem.train.optimizer", "train")

"""The runtime launches a training step: those inside the program's span
`rmem.train.step` (forward, backward on autograd's thread, optimizer) in
the unit traced with the host's spans, over its steps. Fixed by the code.
Layer: the trainer (managers/trainer.py). Moves train_clips_per_s."""

from vosbench.spans import STEP, launches

UNIT = "launches"


def read(ctx):
    return launches(ctx, STEP, "train")

"""The share of the traced window in which no operation ran on the card
(1 - the union of the device operations' intervals over the window),
the card's activity traced alone.
Layer: the device. Moves train_clips_per_s."""

UNIT = "%"


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

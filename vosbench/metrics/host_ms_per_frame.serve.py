"""The host's milliseconds a served frame: the host clock around each
chunk's `scan_steps_multi_raw` call in the timed window, up to the call's
return (before the labels' copy waits for the card), over the frames
served. Layer: the engine (engine/inference.py). Moves serve_fps."""

UNIT = "ms"
CLOCK = "engine.scan_steps_multi_raw"
CLOCKS = [("rmem_tpu_torch.engine.inference",
           "InferenceEngine.scan_steps_multi_raw", CLOCK)]


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["window"]["frames"] \
            or CLOCK not in ctx["host_s"]:
        return None
    return 1e3 * ctx["host_s"][CLOCK] / ctx["window"]["frames"]

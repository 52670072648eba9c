"""Readings of the program's own profiler spans (`rmem.*`, named by
rmem_tpu_torch/utils/trace.py) in the unit traced with the host's spans
(`ctx["span_trace"]`, a vosbench/trace.py Trace): the runtime launches and
the device seconds of the kernels launched inside a span, per frame or per
step of the unit. A launch is inside a span when its runtime call
(cudaLaunch*, cuLaunch*, cudaGraphLaunch) starts inside one of the span's
intervals. Every reading is None where the program has no such span, as a
program from before its spans has none."""

from __future__ import annotations

import bisect
from typing import Dict, Optional

# the spans that bound a traced unit: a served chunk, a training step
CHUNK = "rmem.engine.chunk"
STEP = "rmem.train.step"


def _units(ctx: Dict) -> Optional[float]:
    """The frames (serving) or steps (training) of the traced unit, counted
    by the program's own spans; None without them."""
    tr = ctx.get("span_trace")
    if tr is None:
        return None
    if ctx["kind"] == "serve":
        n = len(tr.spans.get(CHUNK, ())) * ctx["wl"]["chunk"]
    else:
        n = len(tr.spans.get(STEP, ()))
    return n or None


def launches(ctx: Dict, name: str, kind: str) -> Optional[float]:
    """The runtime launches inside spans `name` per frame or step of a
    cell of `kind`."""
    n = _units(ctx) if ctx["kind"] == kind else None
    spans = ctx["span_trace"].spans.get(name) if n else None
    if not spans:
        return None
    ranges = sorted(spans)
    inside = 0
    for at in ctx["span_trace"].launch.values():
        i = bisect.bisect_right(ranges, (at, float("inf"))) - 1
        inside += i >= 0 and ranges[i][0] <= at <= ranges[i][1]
    return inside / n


def device_ms(ctx: Dict, name: str, kind: str) -> Optional[float]:
    """The device milliseconds of the kernels launched inside spans `name`
    per frame or step of a cell of `kind`."""
    n = _units(ctx) if ctx["kind"] == kind else None
    s = ctx["span_trace"].span_device_s(name) if n else None
    return None if s is None else 1e3 * s / n

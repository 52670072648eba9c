"""Reading a torch.profiler trace of the card: the device's busy time as
the union of its operations' intervals, the device time of the kernels
launched inside named host spans, the device operations that took most
time, and the device's idle gaps by the host span that was open at the
time.

A kernel is attributed to a span by its launch: the runtime call
(cudaLaunchKernel and kin) with the kernel's correlation id, whose start
on the host lies inside a span of that name. Threads are not compared (the
profiler numbers a runtime call's thread and a span's differently): the
harness launches from one thread at a time, the autograd engine's while
the main thread waits for the backward.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from torch.autograd import DeviceType

TOP = 10


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """The events of one profiled window of `window_s` seconds; `bounds`,
    its ends on the profiler's clock (ns), where the host was traced."""

    def __init__(self, prof, window_s: float, bounds=None):
        self._window_s = window_s
        self.t0, self.t1 = bounds if bounds else (None, None)
        self.ops: List[Tuple[int, int, str, int]] = []   # device operations
        self.launch: Dict[int, int] = {}                 # corr -> ns
        self.spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        for ev in prof.profiler.kineto_results.events():
            start, dur = ev.start_ns(), ev.duration_ns()
            if ev.device_type() == DeviceType.CUDA:
                if ev.is_user_annotation():
                    continue
                self.ops.append((start, start + dur, ev.name(),
                                 ev.correlation_id()))
            elif ev.is_user_annotation():
                self.spans[ev.name()].append((start, start + dur))
            elif ev.name().startswith(("cudaLaunch", "cuLaunch",
                                       "cudaGraphLaunch")):
                self.launch[ev.correlation_id()] = start
        # every device operation falls in the window: it is synchronised
        # at both ends
        self.busy = _union([(s, e) for s, e, _, _ in self.ops])

    @property
    def window_s(self) -> float:
        return self._window_s

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def matched(self) -> Tuple[int, int]:
        """(device operations whose launch was found, all of them)."""
        return sum(c in self.launch for *_, c in self.ops), len(self.ops)

    def span_device_s(self, name: str) -> Optional[float]:
        """Device seconds of the kernels launched inside spans `name`; None
        where no such span ran."""
        spans = self.spans.get(name)
        if not spans:
            return None
        ranges = sorted(spans)
        total = 0
        for s, e, _, corr in self.ops:
            at = self.launch.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(ranges, (at, float("inf"))) - 1
            if i >= 0 and ranges[i][0] <= at <= ranges[i][1]:
                total += e - s
        return total / 1e9

    def top_ops(self) -> List[List]:
        """The TOP device operations by total seconds, [[name, s], ...]."""
        tot: Dict[str, int] = defaultdict(int)
        for s, e, name, _ in self.ops:
            tot[name[:120]] += e - s
        return [[n, v / 1e9] for n, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[List]:
        """The device's idle time in the window, summed by the innermost
        benchmark span open at each gap's middle, the TOP largest,
        [[name, s], ...]; None where the host was not traced."""
        if self.t0 is None:
            return None
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans = [(s, e, name) for name, lst in self.spans.items()
                 for s, e in lst]
        tot: Dict[str, int] = defaultdict(int)
        for s, e in gaps:
            mid = (s + e) // 2
            inside = [(ee - ss, name) for ss, ee, name in spans
                      if ss <= mid <= ee]
            tot[min(inside)[1] if inside else "outside the window"] += e - s
        return [[n, v / 1e9] for n, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]

"""The readers of the program's own spans (vosbench/spans.py and the
metrics that use it): on a synthetic trace they give the launches and the
device milliseconds inside the spans per frame or step; without the
program's spans (a program from before them) they give None; and a traced
run of each kind at the tiny presets on the CPU reports them."""

from __future__ import annotations

import pytest
import torch
from torch.autograd import DeviceType

from vosbench import harness, run
from vosbench.tests import tiny
from vosbench.trace import Trace

CPU = torch.device("cpu")
SERVE = ("launches_per_frame.serve", "encoder_device_ms.serve",
         "propagation_device_ms.serve")
TRAIN = ("launches_per_step.train", "optimizer_launches.train",
         "backward_device_ms.train")


class _Event:
    def __init__(self, name, start, dur, cuda=False, span=False, corr=0):
        self._e = (name, start, dur, cuda, span, corr)

    def name(self):
        return self._e[0]

    def start_ns(self):
        return self._e[1]

    def duration_ns(self):
        return self._e[2]

    def device_type(self):
        return DeviceType.CUDA if self._e[3] else DeviceType.CPU

    def is_user_annotation(self):
        return self._e[4]

    def correlation_id(self):
        return self._e[5]


def _trace(spans, kernels):
    """A Trace of host spans [(name, start, end)] and kernels [(launch at,
    device ns)], each kernel's device run placed after everything else."""
    events = [_Event(n, s, e - s, span=True) for n, s, e in spans]
    for corr, (at, dur) in enumerate(kernels, 1):
        events.append(_Event("cudaLaunchKernel", at, 5, corr=corr))
        events.append(_Event(f"kernel{corr}", 10 ** 6 + 1000 * corr, dur,
                             cuda=True, corr=corr))

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    return Trace(Prof, 1.0, (0, 2 * 10 ** 6))


def _ctx(kind, tr):
    return dict(kind=kind, span_trace=tr, trace=tr, wl={"chunk": 2},
                calls={}, host_s={})


def _read(name, ctx):
    return harness.reader(name).read(ctx)


def test_serving_readers_count_inside_the_program_spans():
    tr = _trace([("rmem.engine.chunk", 0, 1000),
                 ("rmem.model.encode", 100, 200),
                 ("rmem.model.encode", 500, 600),
                 ("rmem.model.propagation", 200, 400),
                 ("rmem.model.propagation", 600, 800),
                 ("vosbench.engine.propagate", 90, 900)],
                [(150, 30000), (250, 50000), (650, 70000), (550, 20000),
                 (950, 1000), (1500, 9000)])
    ctx = _ctx("serve", tr)
    # 5 launches inside the one chunk of 2 frames; the last is outside it
    assert _read("launches_per_frame.serve", ctx) == pytest.approx(2.5)
    assert _read("encoder_device_ms.serve", ctx) == pytest.approx(0.025)
    assert _read("propagation_device_ms.serve", ctx) == pytest.approx(0.06)
    # a serving reader reads nothing in a training cell
    assert _read("encoder_device_ms.serve", _ctx("train", tr)) is None


def test_training_readers_count_inside_the_program_spans():
    step = [("rmem.train.step", 0, 10000),
            ("rmem.train.backward", 3000, 8000),
            ("rmem.train.optimizer", 8000, 9500)]
    tr = _trace(step + [(n, s + 20000, e + 20000) for n, s, e in step],
                [(1000, 1000), (4000, 40000), (5000, 60000), (8500, 7),
                 (9000, 7), (12000, 500), (24000, 100000)])
    ctx = _ctx("train", tr)
    assert _read("launches_per_step.train", ctx) == pytest.approx(3.0)
    assert _read("optimizer_launches.train", ctx) == pytest.approx(1.0)
    assert _read("backward_device_ms.train", ctx) == pytest.approx(0.1)


@pytest.mark.parametrize("kind,names", [("serve", SERVE), ("train", TRAIN)])
def test_readers_give_none_without_the_program_spans(kind, names):
    """The benchmark's own spans alone, as a program without spans gives
    them: every reader is left out of the line."""
    tr = _trace([("vosbench.engine.propagate", 0, 1000),
                 ("vosbench.train.step", 0, 1000)], [(100, 1000)])
    for name in names:
        assert _read(name, _ctx(kind, tr)) is None
        assert _read(name, _ctx(kind, None)) is None
    readers = {n: harness.reader(n) for n in names}
    assert harness.per_layer_metrics(readers, _ctx(kind, tr)) == {}


@pytest.mark.parametrize("cell,make,names", [
    ("aotl-serve-msflip", tiny.serve_cell, SERVE),
    ("deaotl-train-vost", tiny.train_cell, TRAIN)])
def test_a_traced_tiny_run_reports_the_span_readers(cell, make, names):
    """The harness's whole traced run on the CPU: the program's spans are
    in the trace, so each reader of the cell reports (no kernel runs on a
    card here: the counts are 0)."""
    wl, cfg = make()
    wl["limits"] = harness.cell(cell)["limits"]
    out = run.run_cell(cell, 2 ** 31 + 53, 0.1, True, CPU, wl=wl, cfg=cfg)
    for name in names:
        assert out["metrics"][name] == {"value": 0.0,
                                        "unit": harness.reader(name).UNIT}
    gaps = [n for n, _ in out["breakdown"]["idle_gaps"]]
    assert any(n.startswith("rmem.") for n in gaps), gaps

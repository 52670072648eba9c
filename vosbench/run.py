"""Run one cell of the benchmark once, on one card, and print its result.

    python3 -m vosbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the repository's root. The cell is found by its name in
BENCHMARK.json, its files by the names there (see vosbench/README.md).
The last line of standard output is the result as one JSON object; the
numbers the check compared, each with its limit, are also the last lines
of standard error. The run exits with a code other than 0, and prints no
result, without a CUDA device, or if a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# keep libraries that could load JAX by themselves from doing so
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# the cores a run keeps to (`steady_host`)
HOST_CORES = 4


def parse(argv):
    p = argparse.ArgumentParser(prog="vosbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2) -> None:
    print(msg, file=sys.stderr)
    raise SystemExit(code)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, dev,
             wl=None, cfg=None, faults=(), control: bool = False) -> dict:
    """Set up, time, trace and check one run of the cell on `dev`; returns
    the result (the last line's object). `wl` and `cfg` replace the cell's
    own and `faults` break the timed path (tests); with `control`, the
    check judges the control (the reference in fp8) in the program's place
    by the same limits."""
    import torch
    from vosbench import harness
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    wl = wl or harness.cell(name)
    cfg = cfg or harness.config(wl["config"])
    kind = importlib.import_module(f"vosbench.kinds.{wl['kind']}")
    run = kind.RUN(wl, cfg, seed, dev, faults)
    run.setup()
    sync()
    setup_s = time.perf_counter() - T_START
    readers = {n: harness.reader(n)
               for n in harness.metric_names(name, "per_layer")} \
        if trace else {}
    host_s: dict = {}
    clocks = harness.clocks(readers.values(), host_s)
    # set-up's objects out of the collector's way for the window
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        win = run.window(seconds)
    finally:
        clocks.close()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"set-up {setup_s:.3f} s; window {win}")
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    ctx = dict(kind=wl["kind"], cell=name, wl=wl, cfg=cfg, window=win,
               host_s=host_s, calls={})
    breakdown = None
    if trace:
        from vosbench.trace import Trace
        # the card's activity alone over trace_units (busy and idle time,
        # the top device operations), then one unit with the host's
        # operations and the spans (the kernels launched inside a span, the
        # idle gaps by span), whose tracing slows the host
        prof, window_s, _ = harness.profiled(
            lambda: run.traced(wl["trace_units"]), sync, host=False)
        tr = Trace(prof, window_s)
        del prof
        spans = harness.spans(wl, readers.values(), ctx["calls"])
        try:
            prof, window_s, bounds = harness.profiled(
                lambda: run.traced(1), sync)
        finally:
            spans.close()
        ctx["trace"], ctx["span_trace"] = tr, Trace(prof, window_s, bounds)
        del prof
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_ops(),
                     "idle_gaps": ctx["span_trace"].idle_gaps()}
        matched, ops = ctx["span_trace"].matched()
        log(f"trace: {len(tr.ops)} device operations in {tr.window_s:.3f} s "
            f"({tr.busy_s:.3f} s busy); with the host: {ops}, {matched} with "
            f"their launch found, {ctx['span_trace'].window_s:.3f} s, spans "
            f"{sorted(ctx['span_trace'].spans)}")
        metrics = harness.per_layer_metrics(readers, ctx)
    else:
        metrics = run.end_to_end(win, peak, setup_s,
                                 harness.metric_names(name, "end_to_end"))
    gc.unfreeze()
    run.finish()
    t = time.perf_counter()
    got = run.check(control=control)
    log(f"check {time.perf_counter() - t:.3f} s: " + ", ".join(
        f"{k} {v!r}" for k, v in got.items() if k not in wl["limits"]))
    compared = {k: {"value": float(got[k]), "limit": lim}
                for k, lim in wl["limits"].items()}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    return harness.result(correct, run.attempted(win), 0, metrics, device,
                          compared, breakdown)


def steady_host() -> None:
    """The run on a fixed set of the machine's cores, with one ATen thread:
    the host issues the card's work, and a process whose threads wander
    over cores other work uses reads slower in some runs than in others.
    Before torch is imported, so that every thread it starts inherits the
    set."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[:HOST_CORES])


def main(argv=None) -> None:
    args = parse(argv)
    steady_host()
    from vosbench import harness
    wl = harness.cell(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        fail(f"{args.workload} needs {wl['chips']} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), dev, wl=wl)
    bad = harness.forbidden_modules()
    if bad:
        fail(f"modules loaded that the benchmark may not load: {bad}", 3)
    for k, v in result["compared"].items():
        print(f"{k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()

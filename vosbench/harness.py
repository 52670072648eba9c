"""What every cell's run shares: finding a cell's files by name, the
configuration, spans and host clocks around the program's layers (named
in data: the traffic mix and the per-layer readers), the readers, the
check that the run loaded no JAX, and the result line."""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names a run may not load (compared whole: the package
# under test's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rmem_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(REPO / "BENCHMARK.json")


def cell(name: str) -> Dict:
    """A cell of BENCHMARK.json with its files: the traffic mix
    vosbench/mixes/<traffic>.json and the check's limits
    vosbench/limits/<cell>.json, merged into one dict with the cell's
    `config` and `chips`."""
    found = [w for w in benchmark()["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    w = found[0]
    out = load_json(ROOT / "mixes" / f"{w['traffic']}.json")
    out.update(config=w["config"], chips=w["chips"],
               limits=load_json(ROOT / "limits" / f"{name}.json"))
    return out


def config(name: str):
    """The package's Config of vosbench/configs/<name>.json (the file's
    keys that are Config fields; lists become tuples)."""
    from rmem_tpu_torch.config import Config
    return Config.load(str(ROOT / "configs" / f"{name}.json"))


def host(t):
    """A copy of a tensor on the host (never a view of a CPU tensor)."""
    return t.detach().to("cpu", copy=True)


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def resolve(module: str, attr: str):
    """(owner, name) of the dotted attribute `attr` of `module`: a module
    function ("bank_attention_infer") or a class's method
    ("InferenceEngine.propagate")."""
    owner = importlib.import_module(module)
    *parents, name = attr.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, name


def summary(x):
    """A call's argument as a reader sees it: a tensor of one element
    copied (its value at the call; no read-back), a larger tensor its
    shape, anything else itself."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().clone() if x.numel() == 1 else tuple(x.shape)
    return x


class Patches:
    """Wrappers around calls into the program's layers, undone on
    `close`: profiler spans (`span`) and host clocks (`clock`)."""

    def __init__(self):
        self.undo: List[Callable] = []

    def _wrap(self, owner, attr: str, make: Callable) -> None:
        import functools
        fn = getattr(owner, attr)
        # the wrapper carries fn's attributes: the program's kernel wrappers
        # count their launches on themselves through their module's name
        setattr(owner, attr, functools.wraps(fn)(make(fn)))
        self.undo.append(lambda: setattr(owner, attr, fn))

    def span(self, owner, attr: str, name: str,
             calls: Optional[List] = None) -> None:
        """Each call of owner.attr inside the profiler span `name`; with
        `calls`, each call's arguments by parameter name (`summary`, the
        instance aside) are appended to it."""
        import inspect

        import torch

        def make(fn):
            sig = inspect.signature(fn)

            def spanned(*args, **kwargs):
                if calls is not None:
                    bound = sig.bind(*args, **kwargs)
                    bound.apply_defaults()
                    calls.append({k: summary(v) for k, v in
                                  bound.arguments.items() if k != "self"})
                with torch.profiler.record_function(name):
                    return fn(*args, **kwargs)
            return spanned

        self._wrap(owner, attr, make)

    def clock(self, owner, attr: str, name: str,
              totals: Dict[str, float]) -> None:
        """The host's seconds inside owner.attr, up to its return, summed
        into totals[name]."""
        totals.setdefault(name, 0.0)

        def make(fn):
            def clocked(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    totals[name] += time.perf_counter() - t
            return clocked

        self._wrap(owner, attr, make)

    def close(self) -> None:
        for u in reversed(self.undo):
            u()
        self.undo.clear()


WINDOW_SPAN = "vosbench.window"


def profiled(fn: Callable[[], None], sync: Callable[[], None],
             host: bool = True):
    """Run fn under torch.profiler, synchronised (`sync`) at both ends.
    With `host`, the host's operations and spans are recorded too and fn
    runs inside the span WINDOW_SPAN, whose ends bound the window; without,
    only the card's activity (the profiler's own cost on the host is then
    small) and the window is the host clock's. Returns (prof, window_s,
    (t0_ns, t1_ns) or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        t = time.perf_counter_ns()
        with torch.profiler.record_function(WINDOW_SPAN):
            fn()
            sync()
        window_ns = time.perf_counter_ns() - t
    if not host:
        return prof, window_ns / 1e9, None
    (s, e), = [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
               for ev in prof.profiler.kineto_results.events()
               if ev.is_user_annotation() and ev.name() == WINDOW_SPAN
               and ev.device_type().name == "CPU"]
    return prof, (e - s) / 1e9, (s, e)


def reader(name: str):
    """The per-layer metric's reader module, vosbench/metrics/<name>.py:
    `UNIT`, `read(ctx)`, and optionally `SPANS`, the profiler spans it
    reads in the traced run, and `CLOCKS`, the host clocks it reads from
    the timed window, each a list of (module, attribute, name)."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"vosbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def clocks(readers: Iterable, totals: Dict[str, float]) -> Patches:
    """The host clocks the readers ask for, installed."""
    p = Patches()
    for spec in {c for r in readers for c in getattr(r, "CLOCKS", ())}:
        module, attr, name = spec
        p.clock(*resolve(module, attr), name, totals)
    return p


def spans(wl: Dict, readers: Iterable, calls: Dict[str, List]) -> Patches:
    """The traffic mix's spans (its `spans`, which name the idle gaps in
    the breakdown) and those the readers ask for, installed; each reader's
    span records its calls into calls[name]."""
    p = Patches()
    want = {tuple(s) for s in wl.get("spans", ())}
    recorded = {tuple(s) for r in readers for s in getattr(r, "SPANS", ())}
    for module, attr, name in sorted(want | recorded):
        rec = calls.setdefault(name, []) if (module, attr, name) in recorded \
            else None
        p.span(*resolve(module, attr), name, rec)
    return p


def per_layer_metrics(readers: Dict, ctx: Dict) -> Dict:
    """Each reader run on the context; a reader that returns None is left
    out."""
    out = {}
    for name, mod in readers.items():
        value = mod.read(ctx)
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out


def metric_names(cell_name: str, kind: str) -> List[str]:
    """The BENCHMARK.json metrics of `kind` ("end_to_end" or "per_layer")
    that this cell reports."""
    out = []
    for m in benchmark()[kind]:
        cells = m.get("workloads")
        if cells is None or cell_name in cells:
            out.append(m["name"])
    return out


def result(correct: bool, attempted: int, failed: int, metrics: Dict,
           device: Dict, compared: Dict,
           breakdown: Optional[Dict] = None) -> Dict:
    """The run's result: the keys BENCHMARK.json's readers expect, with the numbers
    compared (each with its limit) last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return out

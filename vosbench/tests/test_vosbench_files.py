"""BENCHMARK.json against its rules of shape, and every entry against
its files: configurations, mixes, generators, run kinds, limits and
per-layer readers, found by name."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys

import pytest
import torch

from vosbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
B = harness.benchmark()
CELLS = [w["name"] for w in B["workloads"]]
METRICS = B["end_to_end"] + B["per_layer"]


def test_top_level_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(B["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               and not p.endswith("_torch") for p in B["paths"])
    assert 1 <= len(B["command"]) <= 32
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert 1 <= len(B["configs"]) <= 24 and 1 <= len(CELLS) <= 24
    assert 1 <= len(B["end_to_end"]) <= 16 and 1 <= len(B["per_layer"]) <= 128
    assert len(json.dumps(B)) <= 64 * 1024


@pytest.mark.parametrize("entry", B["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert entry["file"].startswith(B["paths"][0] + "/")
    cfg = harness.config(entry["name"])
    with open(harness.REPO / entry["file"]) as f:
        raw = json.load(f)
    assert raw["_source"] == entry["source"]
    assert len(entry["reduced"]) <= 16
    assert cfg.model_name == raw["model_name"]
    assert 1 <= len(entry["why"]) <= 200 and 1 <= len(entry["source"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    entry = next(w for w in B["workloads"] if w["name"] == name)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(name) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1
    assert entry["config"] in {c["name"] for c in B["configs"]}
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    wl = harness.cell(name)
    kind = importlib.import_module(f"vosbench.kinds.{wl['kind']}")
    assert hasattr(kind, "RUN")
    importlib.import_module(f"vosbench.traffic.{wl['generator']}")
    assert wl["limits"] and all(v >= 0 for v in wl["limits"].values())
    # every cell reports setup_s, another end-to-end and a per-layer metric
    e2e = harness.metric_names(name, "end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metric_names(name, "per_layer")


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    for cell in m.get("workloads", []):
        assert cell in CELLS
    if m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}
        moved = next(e for e in B["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        path = harness.ROOT / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("reader", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.UNIT == m["unit"] and callable(mod.read)
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_names_unique_and_layers_named():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))
    for m in B["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rmem_tpu_torch_fake_probe",
                        sys.modules["json"])
    assert "rmem_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rmem_tpu.fake_probe",
                        sys.modules["json"])
    assert "rmem_tpu" in harness.forbidden_modules()


def test_benchmark_modules_import_no_jax():
    """The harness's modules import nothing forbidden (checked in a fresh
    interpreter, so this process's imports do not count)."""
    import subprocess
    code = ("import sys, vosbench.run, vosbench.harness, vosbench.trace, "
            "vosbench.kinds.serve, vosbench.kinds.train, "
            "vosbench.counts.model_flops, vosbench.reference.serve; "
            "from vosbench.harness import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.REPO, check=True)
    assert out.stdout.strip() == "[]"


def test_result_line_keys():
    r = harness.result(True, 3, 0, {"setup_s": {"value": 1.0, "unit": "s"}},
                       {"platform": "gpu", "kind": "x", "count": 1,
                        "memory_peak_bytes": 1},
                       {"label_gap": {"value": 0.1, "limit": 0.2}},
                       {"device_ops": [], "idle_gaps": []})
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "breakdown", "compared"]
    assert json.loads(json.dumps(r)) == r


def test_patches_keep_the_wrapped_function_working_and_undo():
    import types
    mod = types.SimpleNamespace()

    def count(x, scale=2):
        mod.count.launches += 1     # as the package's kernel wrappers do
        return x * scale

    count.launches = 0
    mod.count = count
    calls, totals = [], {}
    patches = harness.Patches()
    patches.span(mod, "count", "probe", calls)
    patches.clock(mod, "count", "probe", totals)
    assert mod.count is not count and mod.count(torch.ones(3)).sum() == 6
    assert mod.count.launches == 1 and totals["probe"] > 0
    assert calls == [{"x": (3,), "scale": 2}]
    patches.close()
    assert mod.count is count and mod.count(2) == 4


@pytest.mark.parametrize("name", CELLS)
def test_spans_and_clocks_resolve(name):
    """Every span of the cell's mix and of its readers names an attribute
    of the package that exists."""
    wl = harness.cell(name)
    readers = [harness.reader(n)
               for n in harness.metric_names(name, "per_layer")]
    specs = [*wl.get("spans", ()),
             *(s for r in readers for s in getattr(r, "SPANS", ())),
             *(s for r in readers for s in getattr(r, "CLOCKS", ()))]
    assert specs
    for module, attr, span in specs:
        owner, leaf = harness.resolve(module, attr)
        assert callable(getattr(owner, leaf)) and NAME.match(span)

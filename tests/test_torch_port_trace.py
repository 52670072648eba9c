"""The port's own profiler spans (rmem_tpu_torch/utils/trace.py) on the
CPU: a served multi-aug chunk, the long-term writes named by their
outcome, a training step with its recomputed frames, the evaluator's loop
and a kernel build, each under torch.profiler; with no profiler running
nothing is entered; a graph traced by torch.export holds no profiler
node; every kernel wrapper's launch counter has its span."""

import ast
import collections
import os
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.data.synthetic import gen_blob_batch
from rmem_tpu_torch.engine import InferenceEngine
from rmem_tpu_torch.engine.inference import separate_mask
from rmem_tpu_torch.engine.train_state import TrainState
from rmem_tpu_torch.kernels import build
from rmem_tpu_torch.managers.trainer import train_step
from rmem_tpu_torch.models import build_vos_model, init_params
from rmem_tpu_torch.ops.masks import host_id_shuffle_matrix
from rmem_tpu_torch.ops.resize import resize_nearest
from rmem_tpu_torch.utils import trace
from rmem_tpu_torch.utils.trace import span

KERNELS = Path(__file__).resolve().parents[1] / "rmem_tpu_torch" / "kernels"
RAW_HW = (40, 50)
AUGS = [((49, 65), True), ((33, 49), False)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread, as in the other port files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spans(prof):
    """{name: count} and {(parent, name): count} of the spans named
    `rmem.*`, the parent the innermost span around each (on one thread:
    the CPU runs the backward on the caller's)."""
    ev = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.is_user_annotation() and e.name().startswith("rmem.")),
                key=lambda x: (x[0], -x[1]))
    names, parents, stack = collections.Counter(), collections.Counter(), []
    for s, e, n in ev:
        while stack and stack[-1][1] < e:
            stack.pop()
        names[n] += 1
        parents[(stack[-1][2] if stack else None, n)] += 1
        stack.append((s, e, n))
    return names, parents


def _engine(model, **over):
    cfg = get_config("pre_vost", model=model, compute_dtype="float32",
                     latter_mem_len=2, **over)
    return InferenceEngine(init_params(build_vos_model(cfg.model_vos, cfg)),
                           cfg, device="cpu")


def _raw(frames, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(frames, *RAW_HW, 3) * 255).astype(np.uint8)


def _served(eng, gap=1):
    """Every aug of AUGS given frame 0 of a 12-object video (two id
    groups of the tiny models' 10)."""
    mask = np.zeros((1, *RAW_HW), np.int32)
    for i in range(12):
        mask[:, 5:35, 4 * i:4 * i + 3] = i + 1
    states = []
    for in_hw, flip in AUGS:
        m = torch.from_numpy(mask)
        lab = separate_mask(resize_nearest(
            (m.flip(2) if flip else m)[..., None], in_hw)[..., 0], 2, 10)
        st, _ = eng.add_reference(eng.prep(_raw(1), in_hw, flip)[0], lab,
                                  [10, 2], gap=gap)
        states.append(st)
    return states


def _writes(frames, gap, slots):
    """(spare, append, evict) of one aug's frames 1..frames after its
    reference, by the write schedule: a write every `gap` frames into a
    bank of `slots` = former + latter slots that holds the reference."""
    writes = frames // gap
    append = min(writes, slots - 1)
    return frames - writes, append, writes - append


@pytest.mark.parametrize("model", ["tiny_aotl", "tiny_deaotl"])
def test_served_chunk_spans_nest(model):
    """A multi-aug chunk of raw frames, two id groups, the bank filling
    and evicting: each layer's span, as many as the chunk runs, inside the
    one above it."""
    eng = _engine(model)
    states = _served(eng)
    k, a = 5, len(AUGS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.scan_steps_multi_raw(states, _raw(k, 1), [h for h, _ in AUGS],
                                 RAW_HW, [f for _, f in AUGS])
    names, parents = _spans(prof)
    layers = eng.cfg.model_lstt_num
    want = {
        (None, "rmem.engine.chunk"): 1,
        ("rmem.engine.chunk", "rmem.engine.prep"): a,
        ("rmem.engine.chunk", "rmem.engine.frame"): k,
        ("rmem.engine.frame", "rmem.engine.propagate"): k * a,
        ("rmem.engine.frame", "rmem.engine.aug_label"): k,
        ("rmem.engine.frame", "rmem.engine.update_memory"): k * a,
        ("rmem.engine.propagate", "rmem.model.encode"): k * a,
        ("rmem.engine.propagate", "rmem.model.propagation"): k * a,
        ("rmem.engine.propagate", "rmem.model.decode"): k * a,
        ("rmem.model.block.long", "rmem.kernel.bank_attention_infer"):
            k * a * layers,
    }
    parts = ["self", "long", "short"]
    if model == "tiny_aotl":
        parts.append("ffn")
    else:   # the GPM's short-term attention is kernel K4
        want[("rmem.model.block.short", "rmem.kernel.local_attention")] = (
            k * a * layers)
    for part in parts:
        want[("rmem.model.propagation", f"rmem.model.block.{part}")] = (
            k * a * layers)
    spare, append, evict = _writes(k, 1, 3)
    for outcome, n in (("append", append * a), ("evict", evict * a)):
        want[("rmem.engine.update_memory",
              f"rmem.memory.write.{outcome}")] = n
    assert spare == 0
    assert dict(parents) == want


@pytest.mark.parametrize("model,gap,frames,over", [
    ("tiny_deaotl", 2, 9, {}),
    ("tiny_aotl", 3, 10, {"gru_memory": True})],
    ids=["deaotl_single_aug", "aotl_gru"])
def test_write_spans_follow_the_schedule(model, gap, frames, over):
    """The long-term write's span names its outcome as the host's
    schedule has it: as many `spare`, `append` and `evict` spans as the
    frames, the gap and the bank's slots give (the ConvGRU memory writes
    nothing between its writes, so it has no spare span)."""
    eng = _engine(model, **over)
    in_hw, flip = AUGS[0]
    state = _served(eng, gap)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = eng.scan_steps_raw(state, _raw(frames, 2), in_hw, RAW_HW,
                                      flip)
    names, _ = _spans(prof)
    cfg = eng.cfg
    spare, append, evict = _writes(frames, gap,
                                   cfg.former_mem_len + cfg.latter_mem_len)
    assert evict > 0 and append > 0
    if cfg.gru_memory_active:
        spare = 0
    assert [names[f"rmem.memory.write.{o}"] for o in
            ("spare", "append", "evict")] == [spare, append, evict]
    assert state.long_writes == append + evict


@pytest.mark.parametrize("model", ["tiny_deaotl", "tiny_aotl"])
def test_training_step_spans(model):
    """A step of 4 frames, each checkpointed: forward, backward and
    optimizer inside the step; the frames' propagation and decode inside
    the forward, and again, recomputed under their own names, inside the
    backward."""
    t = 4
    cfg = get_config("test", model=model, compute_dtype="float32",
                     data_seq_len=t, train_batch_size=1, latter_mem_len=1,
                     train_long_term_mem_gap=1)
    state = TrainState.create(init_params(build_vos_model(cfg.model_vos,
                                                          cfg)))
    batch = gen_blob_batch(torch.Generator().manual_seed(0), 1, t, (33, 33))
    shuffle = torch.from_numpy(host_id_shuffle_matrix(
        np.random.RandomState(0), 11, 1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, batch, shuffle, cfg)
    _, parents = _spans(prof)
    rc = trace.RECOMPUTE
    for p, n, count in [
            (None, "rmem.train.step", 1),
            ("rmem.train.step", "rmem.train.forward", 1),
            ("rmem.train.step", "rmem.train.backward", 1),
            ("rmem.train.step", "rmem.train.optimizer", 1),
            ("rmem.train.forward", "rmem.model.encode", 1),
            ("rmem.train.forward", "rmem.model.propagation", t),
            ("rmem.train.forward", "rmem.model.decode", t),
            ("rmem.train.backward", "rmem.model.propagation" + rc, t - 1),
            ("rmem.train.backward", "rmem.model.decode" + rc, t - 1),
            ("rmem.model.propagation" + rc, "rmem.model.block.long" + rc,
             (t - 1) * cfg.model_lstt_num)]:
        assert parents[(p, n)] == count, (p, n, parents)
    assert not any(n.startswith("rmem.train.") and n.endswith(rc)
                   for _, n in parents)


def test_recompute_suffix_inside_the_backward_but_not_on_its_own_spans():
    """Inside a backward a checkpoint's rerun forward is `.recompute`, a
    kernel wrapper's forward that it calls (a custom Function's forward,
    which runs with grad off) too; a span of the backward itself
    (`backward=True`) keeps its name."""

    class Square(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            with span("rmem.test.kernel"):
                ctx.save_for_backward(x)
                return x * x

        @staticmethod
        def backward(ctx, g):
            x, = ctx.saved_tensors     # rerun by the checkpoint
            with span("rmem.test.bwd", backward=True):
                return 2 * x * g

    def fwd(x):
        with span("rmem.test.fwd"):
            return Square.apply(x.sin())

    x = torch.ones(3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        checkpoint(fwd, x, use_reentrant=False).sum().backward()
    _, parents = _spans(prof)
    rc = trace.RECOMPUTE
    assert dict(parents) == {
        (None, "rmem.test.fwd"): 1, ("rmem.test.fwd", "rmem.test.kernel"): 1,
        (None, "rmem.test.fwd" + rc): 1,
        ("rmem.test.fwd" + rc, "rmem.test.kernel" + rc): 1,
        (None, "rmem.test.bwd"): 1}


@pytest.mark.parametrize("what", ["served_frame", "training_step"])
def test_without_a_profiler_no_span_is_entered(monkeypatch, what):
    """No profiler: every span is the one shared null context, and a
    served frame and a training step run with the profiler's ranges
    (record_function and the binding a span enters) made to raise."""

    def boom(*a, **k):
        raise AssertionError("a profiler range entered with no profiler")

    assert span("rmem.a") is span("rmem.b")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(trace, "_enter", boom)
    if what == "served_frame":
        eng = _engine("tiny_aotl")
        states = _served(eng)
        eng.scan_steps_multi_raw(states, _raw(2, 1), [h for h, _ in AUGS],
                                 RAW_HW, [f for _, f in AUGS])
    else:
        cfg = get_config("test", model="tiny_deaotl",
                         compute_dtype="float32", data_seq_len=3,
                         train_batch_size=1)
        state = TrainState.create(init_params(build_vos_model("deaot",
                                                              cfg)))
        batch = gen_blob_batch(torch.Generator().manual_seed(0), 1, 3,
                               (33, 33))
        train_step(state, batch, None, cfg)
        assert state.step == 1


def test_export_records_no_profiler_node():
    """torch.export of the serving step, with a profiler running around
    it: a span is a null context while the graph is traced, so the trace
    holds the eager reference frame's spans and none of the traced step's,
    and the graph holds the step's operations and no profiler op."""
    from rmem_tpu_torch.tools.export import build_exported
    cfg = get_config("test", model="tiny_deaotl", compute_dtype="float32")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exported, _, _ = build_exported(cfg, hw=(65, 65), device="cpu")
    names, _ = _spans(prof)
    assert names["rmem.model.encode"] == 1          # add_reference's
    assert names["rmem.engine.propagate"] == 0      # functional_step's
    targets = [str(n.target) for n in exported.graph.nodes]
    assert any("conv2d" in t for t in targets)
    assert not [t for t in targets if "profiler" in t
                or "record_function" in t]


def test_every_launch_counter_has_its_kernel_span():
    """Each kernel wrapper that counts its launches (`<name>.launches +=
    1`) is decorated with the span `rmem.kernel.<name>`, the backward
    wrappers' marked as the backward's own."""
    found = {}
    for path in sorted(KERNELS.glob("*.py")):
        for fn in ast.parse(path.read_text()).body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            counts = any(isinstance(n, ast.AugAssign)
                         and isinstance(n.target, ast.Attribute)
                         and n.target.attr == "launches"
                         for n in ast.walk(fn))
            if counts:
                found[fn.name] = [ast.unparse(d) for d in fn.decorator_list]
    assert len(found) >= 13, sorted(found)
    for name, decorators in found.items():
        backward = ", backward=True" if "_bwd" in name else ""
        assert f"spanned('rmem.kernel.{name}'{backward})" in decorators, name


def test_kernel_build_span(monkeypatch, tmp_path):
    """A build that runs the compiler is the span `rmem.kernels.build`; a
    library already built is found with no span (a stand-in compiler that
    writes its output file)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = -o ]; then : > "$2"; fi; shift\ndone\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build.build(["stem", "gated_dwconv"])
        build.build(["stem"])
    names, _ = _spans(prof)
    assert dict(names) == {"rmem.kernels.build": 1}
    assert build.library_path("stem").exists()


def _vost_tree(root, frames, hw):
    """A VOST-layout tree of one seeded video, its first frame annotated
    with three objects."""
    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(root, "ImageSets"))
    with open(os.path.join(root, "ImageSets", "val.txt"), "w") as f:
        f.write("vid\n")
    img_dir = os.path.join(root, "JPEGImages_10fps", "vid")
    ann_dir = os.path.join(root, "Annotations", "vid")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    for t in range(frames):
        cv2.imwrite(os.path.join(img_dir, f"{t:05d}.jpg"),
                    (rng.rand(*hw, 3) * 255).astype(np.uint8))
    lab = np.zeros(hw, np.uint8)
    for i in range(3):
        lab[10:50, 20 * i + 5:20 * i + 15] = i + 1
    img = Image.fromarray(lab, mode="P")
    img.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0] * 64)
    img.save(os.path.join(ann_dir, "00000.png"))


def test_evaluator_loop_spans(tmp_path):
    """The evaluator under a profiler (tools/eval.py --profile): its wait
    for each decoded frame and each mask handed to the writer are spans,
    and the engine's chunks lie in the loop."""
    from rmem_tpu_torch.managers.evaluator import Evaluator
    frames, hw = 6, (64, 96)
    _vost_tree(str(tmp_path / "data" / "VOST"), frames, hw)
    cfg = get_config("pre_vost", model="tiny_deaotl", test_dataset="vost",
                     compute_dtype="float32", eval_scan_chunk=4)
    model = init_params(build_vos_model("deaot", cfg))
    ev = Evaluator(cfg, params=model.state_dict(),
                   data_root=str(tmp_path / "data"),
                   output_root=str(tmp_path / "out"), log=lambda *a: None,
                   device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ev.evaluate()
    names, _ = _spans(prof)
    # every frame's arrival and the end of the video's frames
    assert names["rmem.eval.decode"] == frames + 1
    # the first annotation is copied, the other frames' masks written
    assert names["rmem.eval.save"] == frames - 1
    assert names["rmem.engine.chunk"] == -(-(frames - 1) // 4)
    assert len(list((tmp_path / "out").rglob("*.png"))) == frames

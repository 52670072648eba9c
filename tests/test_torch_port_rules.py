"""Rules of the port: it imports neither JAX nor the JAX package, its
entry points never fall back to the CPU unasked, and neither a served frame
(one aug, or raw frames through several augs with two id groups) nor a
training step reads a device value back to the host."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rmem_tpu_torch.config import get_config
from rmem_tpu_torch.data.synthetic import gen_blob_batch
from rmem_tpu_torch.engine import InferenceEngine
from rmem_tpu_torch.engine.inference import separate_mask
from rmem_tpu_torch.engine.train_state import TrainState
from rmem_tpu_torch.managers.trainer import train_step
from rmem_tpu_torch.models import build_vos_model, init_params
from rmem_tpu_torch.ops.masks import host_id_shuffle_matrix
from rmem_tpu_torch.ops.resize import resize_nearest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "rmem_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """ATen on one thread here: the test workers share few cores, and
    PyTorch's default of one thread per visible CPU makes each of them
    wait on the others many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_blocked():
    """Each module imports in a fresh interpreter where `jax`, `flax` and
    `rmem_tpu` cannot be imported."""
    mods = list(_modules())
    assert "rmem_tpu_torch.engine.inference" in mods
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'rmem_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


IMPORT_RE = re.compile(
    r"^\s*(?:from\s+(jax|flax|rmem_tpu)(?:\.|\s)|import\s+(jax|flax|rmem_tpu)"
    r"(?:\.|\s|,|$))", re.MULTILINE)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    hits = IMPORT_RE.findall(path.read_text())
    assert not hits, f"{path}: imports {hits}"


def test_engine_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("pre_vost", model="tiny_deaotl")
    model = build_vos_model("deaot", cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model, cfg)
    # the CPU on request
    eng = InferenceEngine(model, cfg.replace(compute_dtype="float32"),
                          device="cpu")
    assert eng.device.type == "cpu"


def test_engine_step_reads_nothing_back_to_the_host():
    """A frame with the bank full and evicting makes no host read of a
    device value (`.item()`, `bool(tensor)`, indexing by a 0-d tensor): on
    the card each would stall the host until the frame's work so far ran."""
    cfg = get_config("pre_vost", model="tiny_deaotl", latter_mem_len=2,
                     compute_dtype="float32")
    eng = InferenceEngine(init_params(build_vos_model("deaot", cfg)), cfg,
                          device="cpu")
    rng = np.random.RandomState(0)
    lab = np.zeros((1, 64, 64), np.int32)
    lab[:, 10:30, 10:30] = 1
    state, _ = eng.add_reference(rng.rand(1, 64, 64, 3).astype(np.float32),
                                 lab, [1], gap=1)
    frames = torch.from_numpy(rng.rand(5, 1, 64, 64, 3).astype(np.float32))
    state, _ = eng.scan_steps(state, frames[:4], (60, 70))   # fill, evict
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step(state, frames[4], (60, 70))
    assert _host_reads(prof) == []


def test_raw_multi_aug_step_reads_nothing_back_to_the_host():
    """One frame of raw uint8 input through two augs (one flipped, one at
    another scale) with 12 objects as two id groups, the bank full and
    evicting: prep, propagate, group merge, aug average and the memory
    writes make no host read of a device value."""
    cfg = get_config("pre_vost", model="tiny_deaotl", latter_mem_len=1,
                     compute_dtype="float32")
    eng = InferenceEngine(init_params(build_vos_model("deaot", cfg)), cfg,
                          device="cpu")
    rng = np.random.RandomState(0)
    raw = (rng.rand(4, 40, 50, 3) * 255).astype(np.uint8)
    mask = np.zeros((1, 40, 50), np.int32)
    for i in range(12):
        mask[:, 5:35, 4 * i:4 * i + 3] = i + 1
    in_hws, flips = [(49, 65), (33, 49)], [True, False]
    states = []
    for in_hw, flip in zip(in_hws, flips):
        lab = separate_mask(resize_nearest(
            torch.from_numpy(mask).flip(2)[..., None] if flip
            else torch.from_numpy(mask)[..., None], in_hw)[..., 0], 2, 10)
        st, _ = eng.add_reference(eng.prep(raw[:1], in_hw, flip)[0], lab,
                                  [10, 2], gap=1)
        states.append(st)
    states, _ = eng.scan_steps_multi_raw(states, raw[1:3], in_hws, (40, 50),
                                         flips)             # fill, evict
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.scan_steps_multi_raw(states, raw[3:], in_hws, (40, 50), flips)
    assert _host_reads(prof) == []


def _host_reads(prof):
    return [e.key for e in prof.key_averages()
            if e.key in ("aten::item", "aten::_local_scalar_dense",
                         "aten::is_nonzero", "aten::nonzero")]


@pytest.mark.parametrize("step", [0, 60], ids=["gt_labels", "curriculum"])
def test_train_step_reads_nothing_back_to_the_host(step):
    """A training step (3 frames, each checkpointed, a long-term write
    every frame into 1 + 1 slots, so the bank fills and evicts) reads no
    device value on the host, forward, recompute and backward, with the
    ground-truth labels and under the use_prev_pred curriculum: the frame
    loop branches on host integers only."""
    cfg = get_config("test", model="tiny_deaotl", compute_dtype="float32",
                     data_seq_len=3, train_batch_size=1, latter_mem_len=1,
                     train_long_term_mem_gap=1)
    state = TrainState.create(init_params(build_vos_model("deaot", cfg)))
    state.step = step
    batch = gen_blob_batch(torch.Generator().manual_seed(0), 1, 3, (33, 33))
    shuffle = torch.from_numpy(host_id_shuffle_matrix(
        np.random.RandomState(0), 11, 1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, batch, shuffle, cfg)
    assert _host_reads(prof) == []

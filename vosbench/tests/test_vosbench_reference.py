"""The plain reference against the package's CPU path, at the tiny
presets in f32: serving through the serving run (every frame's served label and
every eviction against the teacher-forced reference) and training (each
step's loss, the first gradient and the change of every leaf, over
set-up's first steps and the warm steps after the window)."""

from __future__ import annotations

import pytest
import torch

from vosbench.kinds.serve import ServeRun
from vosbench.kinds.train import TrainRun
from vosbench.tests import tiny

CPU = torch.device("cpu")
MODELS = ["tiny_deaotl", "tiny_aotl"]


@pytest.mark.parametrize("model", MODELS)
def test_serving_matches_the_reference(model):
    wl, cfg = tiny.serve_cell(model)
    run = ServeRun(wl, cfg, 2 ** 31 + 11, CPU)
    run.setup()
    run.window(0.01)
    run.finish()
    got = run.check()
    assert got["frames_checked"] >= 20 and got["evictions_checked"] >= 8
    assert got["victims_unknown"] == 0 and got["slot_mismatch"] == 0
    assert got["label_gap"] <= 1e-5
    assert got["evict_gap"] <= 1e-6


@pytest.mark.parametrize("model", MODELS)
def test_training_matches_the_reference(model):
    wl, cfg = tiny.train_cell(model)
    run = TrainRun(wl, cfg, 2 ** 31 + 13, CPU)
    run.setup()
    run.window(0.01)
    run.finish()
    got = run.check()
    assert len(got["warm"]["losses"]) == wl["warm_steps"]
    assert got["loss_gap"] <= 1e-5
    assert got["grad_gap"] <= 1e-4
    assert got["change_gap"] <= 1e-4

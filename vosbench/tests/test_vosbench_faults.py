"""A run with its timed path broken comes out not correct: the harness's
whole run (set-up, window, check against the cells' own limits) at the
tiny presets on the CPU, the look for a card skipped, once for each fault
a cell can have; and so does a run whose check judges the control (the
reference in fp8) in the program's place."""

from __future__ import annotations

import pytest
import torch

from vosbench import harness, run
from vosbench.kinds.train import NUMBERS, TrainRun
from vosbench.tests import tiny

CPU = torch.device("cpu")
# each kind of cell at both propagation layers, under its cell's limits
SERVE = (("aotl-serve-msflip", "tiny_aotl"),
         ("aotl-serve-msflip", "tiny_deaotl"))
TRAIN = (("deaotl-train-vost", "tiny_deaotl"),
         ("deaotl-train-vost", "tiny_aotl"))


def _tiny(name, model):
    make = tiny.serve_cell if name.endswith("-msflip") else tiny.train_cell
    wl, cfg = make(model)
    wl["limits"] = harness.cell(name)["limits"]
    return wl, cfg


@pytest.mark.parametrize("name,model,fault", [
    *((n, m, f) for n, m in SERVE for f in ("frozen", "half", "label")),
    *((n, m, f) for n, m in TRAIN for f in ("frozen", "half", "loss"))])
def test_a_broken_run_is_not_correct(name, model, fault):
    wl, cfg = _tiny(name, model)
    out = run.run_cell(name, 2 ** 31 + 29, 0.2, False, CPU, wl=wl, cfg=cfg,
                       faults=(fault,))
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("fault", ["frozen", "half", "loss"])
def test_a_training_fault_after_set_up_is_caught_by_the_warm_steps(fault):
    """The faults start with the window: set-up's steps read sound, the
    warm steps after the window do not."""
    wl, cfg = _tiny(*TRAIN[0])
    r = TrainRun(wl, cfg, 2 ** 31 + 43, CPU, (fault,))
    r.setup()
    r.window(0.01)
    r.finish()
    got = r.check()
    lim = wl["limits"]
    assert all(got["start"][k] <= lim[k] for k in NUMBERS), got["start"]
    assert any(got["warm"][k] > lim[k] for k in NUMBERS), got["warm"]


@pytest.mark.parametrize("name,model", [*SERVE, *TRAIN])
def test_a_sound_run_is_correct(name, model):
    wl, cfg = _tiny(name, model)
    out = run.run_cell(name, 2 ** 31 + 31, 0.2, False, CPU, wl=wl, cfg=cfg)
    assert out["correct"] is True, out["compared"]


@pytest.mark.parametrize("name,model", [*SERVE, *TRAIN])
def test_the_control_is_not_correct(name, model):
    wl, cfg = _tiny(name, model)
    out = run.run_cell(name, 2 ** 31 + 37, 0.2, False, CPU, wl=wl, cfg=cfg,
                       control=True)
    assert out["correct"] is False, out["compared"]
    if (name, model) in SERVE:
        # the number that separates the control on every seed at the
        # cells' own size
        got = out["compared"]["bank_gap"]
        assert got["value"] > got["limit"], out["compared"]

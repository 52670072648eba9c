"""Every cell at its own size on the card, for a short window: the run
completes, reports its metrics and comes out correct. Skips without a
CUDA device."""

from __future__ import annotations

import pytest

from vosbench import harness, run

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name):
    out = run.run_cell(name, 2 ** 31 + 41, 2.0, False, card)
    assert out["correct"] is True, out["compared"]
    assert set(out["metrics"]) == set(harness.metric_names(name,
                                                           "end_to_end"))
    assert out["device"]["platform"] == "gpu"

"""The readers of the program's per-shape feature-build counters.

``prioritizer.shape_path_pct`` and ``prioritizer.shape_evals_per_rank``
read ``rank.shape_path`` and ``rank.shape_evals``.  Each gives None where
the program has no recorder, or a recorder without those counters (an
older checkout), and the right number on a synthetic window; a traced run
on the CPU reports both."""
from __future__ import annotations

import sys

import pytest
import torch

from perfbench import run, span_reader

NAMES = ("prioritizer.shape_path_pct", "prioritizer.shape_evals_per_rank")
#: four rankings, three built per shape over 36 shapes in all
COUNTERS = {"rank.decisions": 4, "rank.futile": 1, "rank.shape_path": 3,
            "rank.shape_evals": 36}
WANT = {"prioritizer.shape_path_pct": 75.0,
        "prioritizer.shape_evals_per_rank": 12.0}


def _ctx(**kw):
    ctx = {"passes": 4, "has_predictor": True, "spans": {},
           "counters": COUNTERS}
    ctx.update(kw)
    return ctx


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_a_synthetic_window(name):
    read = run.load_reader(run.ROOT, name)
    assert read(_ctx()) == pytest.approx(WANT[name])
    assert read(_ctx(spans=None, counters=None)) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_on_a_recorder_without_the_counters(name):
    """The parent program records ``rank.decisions`` but builds features
    without the shape route: nothing to read, not 0."""
    older = {k: v for k, v in COUNTERS.items() if not k.startswith("rank.sh")}
    assert run.load_reader(run.ROOT, name)(_ctx(counters=older)) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_without_the_programs_recorder(name, monkeypatch):
    import repro_torch.core
    monkeypatch.delattr(repro_torch.core, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    assert span_reader.recorder() is None
    ctx = {"passes": 4, "has_predictor": True}
    assert run.load_reader(run.ROOT, name)(ctx) is None


def test_a_traced_run_reports_the_shape_counters(checkout):
    torch.set_num_threads(1)
    result, _ = run.measure(checkout, "small", 2147483701, 0.3, True,
                            torch.device("cpu"))
    assert result["correct"], result["compared"]
    got = result["metrics"]
    # every ranking of the cell builds its features once, per shape
    assert got["prioritizer.shape_path_pct"]["value"] == 100.0
    # the trace derives CPU and memory from the GPU count: a few shapes of
    # num_gpus x gpu_type, not one a row
    assert 1.0 <= got["prioritizer.shape_evals_per_rank"]["value"] <= 24.0

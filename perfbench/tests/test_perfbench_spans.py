"""The readers of the program's own spans and counters, and the gap namer.

Each reader gives None where the program has no span recorder (an older
checkout) and the right number on a synthetic window; a traced run on the
CPU reports them all, and none of them without the recorder, while every
other metric reads as before."""
from __future__ import annotations

import sys

import pytest
import torch

from perfbench import run, span_reader

NEW = {
    # name: (value on SYNTH, needs the predictor)
    "prioritizer.features_ms_per_pass": (3.0, False),
    "prioritizer.actor_ms_per_pass": (0.5 + 0.25, False),
    "prioritizer.futile_pct": (25.0, False),
    "engine.events_ms_per_pass": (0.125, False),
    "engine.backfill_ms_per_pass": (1.0 + 0.5, False),
    "engine.hooks_ms_per_pass": (0.0625, False),
    "placement.milp_solve_ms_per_pass": (4.0, False),
    "placement.milp_hit_pct": (20.0, False),
    "predictor.rows_ms_per_pass": (0.75 + 0.25, True),
    "predictor.forward_ms_per_pass": (2.0, True),
    "predictor.sgd_ms_per_pass": (0.375, True),
    "device.copies_per_pass": (3.5, False),
    "prioritizer.sort_ms_per_pass": (0.25, False),
    "engine.step_self_ms_per_pass": (0.125 + 0.0625, False),
    "placement.head_failed_ms_per_pass": (0.125, False),
    "placement.head_failed_pct": (25.0, False),
    "engine.backfill_tried_per_pass": (2.0, False),
    "engine.backfill_failed_pct": (25.0, False),
    "predictor.param_uploads_per_pass": (1.5, True),
    "device.copy_bytes_per_pass": (300.0, False),
}


def _ns(ms_per_pass, passes=4):
    return int(ms_per_pass * passes * 1e6)


#: a window of four passes: {name: [count, wall_ns, self_ns]}
SYNTH_SPANS = {
    "rltune.step": [4, _ns(12.0), _ns(0.125)],
    "rltune.schedule": [4, _ns(10.0), _ns(0.0625)],
    "rltune.rank": [4, _ns(4.0), _ns(0.25)],
    "rltune.place.head": [3, _ns(0.5), _ns(0.5)],
    "rltune.place.head_failed": [1, _ns(0.125), _ns(0.125)],
    "rltune.rank.features": [4, _ns(3.0), _ns(3.0)],
    "rltune.rank.actor": [4, _ns(0.5), _ns(0.5)],
    "rltune.rank.tail": [4, _ns(0.25), _ns(0.25)],
    "rltune.events": [4, _ns(0.2), _ns(0.125)],
    "rltune.backfill": [2, _ns(3.0), _ns(1.0)],
    "rltune.backfill.reserve": [2, _ns(0.5), _ns(0.5)],
    "rltune.hooks": [9, _ns(0.5), _ns(0.0625)],
    "rltune.milp.solve": [3, _ns(4.0), _ns(3.5)],
    "rltune.predict.rows": [3, _ns(0.75), _ns(0.75)],
    "rltune.predict.submit": [1, _ns(0.25), _ns(0.25)],
    "rltune.predict.forward": [3, _ns(2.0), _ns(2.0)],
    "rltune.predict.sgd": [2, _ns(0.375), _ns(0.375)],
}
SYNTH_COUNTERS = {"rank.decisions": 8, "rank.futile": 2, "milp.hits": 1,
                  "milp.solves": 3, "milp.greedy": 1,
                  "device.h2d_copies": 10, "device.d2h_copies": 4,
                  "backfill.tried": 8, "backfill.failed": 2,
                  "predict.param_uploads": 6, "device.h2d_bytes": 1000,
                  "device.d2h_bytes": 200}


def _ctx(**kw):
    ctx = {"passes": 4, "has_predictor": True, "spans": SYNTH_SPANS,
           "counters": SYNTH_COUNTERS}
    ctx.update(kw)
    return ctx


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_on_a_synthetic_window(name):
    read = run.load_reader(run.ROOT, name)
    want, needs_pred = NEW[name]
    assert read(_ctx()) == pytest.approx(want)
    assert read(_ctx(spans=None, counters=None)) is None
    if needs_pred:
        assert read(_ctx(has_predictor=False)) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_without_the_programs_recorder(name, monkeypatch):
    """An older program has no ``repro_torch.core.spans``: nothing to read."""
    import repro_torch.core
    monkeypatch.delattr(repro_torch.core, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    assert span_reader.recorder() is None
    ctx = {"passes": 4, "has_predictor": True}
    assert run.load_reader(run.ROOT, name)(ctx) is None


def test_percentages_need_a_denominator():
    ctx = _ctx(spans={}, counters={"rank.futile": 0, "backfill.failed": 0})
    for name in ("prioritizer.futile_pct", "placement.milp_hit_pct",
                 "placement.head_failed_pct", "engine.backfill_failed_pct"):
        assert run.load_reader(run.ROOT, name)(ctx) is None


def test_gap_goes_to_the_innermost_span():
    # a gap of 100 µs: the pass range covers all of it, rltune.step 90,
    # rltune.schedule 80 inside it, rltune.rank 60 inside that
    spans = [(95.0, 195.0, "rltune.step", 0),
             (105.0, 185.0, "rltune.schedule", 1),
             (110.0, 170.0, "rltune.rank", 2)]
    ranges = [(90.0, 200.0, "perfbench.pass")]
    name, share = span_reader.name_gap(100.0, 200.0, spans, ranges)
    assert name == "rltune.rank"
    assert share == pytest.approx({"rltune.rank": 60.0,
                                   "rltune.schedule": 20.0,
                                   "rltune.step": 15.0,
                                   "perfbench.pass": 5.0})
    # no program span over the gap: the innermost benchmark range names it
    name, _ = span_reader.name_gap(
        300.0, 400.0, spans, [(250.0, 450.0, "perfbench.pass"),
                              (290.0, 410.0, "perfbench.restore")])
    assert name == "perfbench.restore"
    assert span_reader.name_gap(500.0, 600.0, spans, ranges)[0] == "host"


class _Rec:
    """A recorder's surface: its events in perf-counter ns and the anchor."""

    def __init__(self, events, names, anchor_ns):
        from repro_torch.core.spans import Recorder
        self.events, self.names = events, names
        self.anchor = {"time_ns": 0, "perf_ns": 0,
                       "profiler_perf_ns": anchor_ns}
        self.trace_us = Recorder.trace_us.__get__(self)


def test_gaps_named_through_the_anchor():
    # the anchor ends at ts 1,000 µs, where the recorder read 5e6 ns; a
    # span from 5.2e6 to 5.9e6 ns sits at ts 1,200-1,900 µs
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "rltune.anchor",
         "ts": 990.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1000.0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 2000.0, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 2500.0,
         "dur": 5.0},
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.pass",
         "ts": 1050.0, "dur": 1000.0}]}
    rec = _Rec([(5_200_000, 5_900_000, 0, 0)], ["rltune.step"], 5_000_000)
    gaps = span_reader.name_gaps(doc, rec)
    assert gaps[0][0] == pytest.approx(900.0)
    assert gaps[0][1] == "rltune.step"
    assert gaps[0][2]["rltune.step"] == pytest.approx(700.0)
    assert gaps[1][1] == "host"


def test_copies_outside_the_benchmarks_ranges():
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.restore",
         "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.digest",
         "ts": 500.0, "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 50.0, "dur": 1.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable)",
         "ts": 120.0, "dur": 1.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 200.0, "dur": 1.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device)",
         "ts": 201.0, "dur": 1.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device)",
         "ts": 550.0, "dur": 1.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 300.0,
         "dur": 1.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 310.0,
         "dur": 1.0}]}
    assert span_reader.count_copies(doc) == 1


def test_a_traced_run_reports_the_new_metrics(checkout):
    torch.set_num_threads(1)
    result, _ = run.measure(checkout, "small-pred", 2147483659, 0.5, True,
                            torch.device("cpu"))
    assert result["correct"], result["compared"]
    got = result["metrics"]
    for name in NEW:
        assert name in got, name
        assert got[name]["value"] >= 0.0
    # no card: nothing copied to one
    assert got["device.copies_per_pass"]["value"] == 0.0
    assert got["device.copy_bytes_per_pass"]["value"] == 0.0
    for name in NEW:
        if name.endswith("_pct"):
            assert got[name]["value"] <= 100.0, name


def test_without_the_recorder_only_the_new_metrics_go(checkout, monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(span_reader, "recorder", lambda: None)
    result, _ = run.measure(checkout, "small", 3, 0.3, True,
                            torch.device("cpu"))
    assert result["correct"], result["compared"]
    got = result["metrics"]
    assert not set(got) & set(NEW)
    for name in ("engine.pass_p50_ms", "engine.self_ms_per_pass",
                 "prioritizer.rank_ms_per_pass"):
        assert name in got

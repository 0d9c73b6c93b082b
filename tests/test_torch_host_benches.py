"""The port's host benches against the reference's on the CPU:
``bench_streaming`` (3 scenarios x windows 256/1,024 and the flash-crowd
deep-queue point at 4,096, ``NUM_JOBS`` cut to 300) and ``bench_scale_curve``
at smoke size (windows 1,024/2,048, a 1,000-job trace point, the 8 x 125-node
fleet serial and parallel, 200 MILP calls).  Each package writes its JSON
document into a temporary directory; the two must agree field for field
once ``benchmarks_torch.common.CLOCK_FIELDS`` are masked:

- provenance and the host: ``provenance``, ``host``, ``machine``;
- every field that reads a clock: ``wall_s``, ``wall_serial_s``,
  ``wall_parallel_s``, ``wall_uncached_s``, ``wall_cached_s``,
  ``jobs_per_s``, ``lat_mean_ms``, ``lat_p99_ms``, ``speedup_vs_pre_pr``,
  ``parallel_speedup``, ``cache_speedup``, ``peak_rss_mb``, and the
  verdicts computed from latencies (``latency_ratio``, ``sublinear``,
  ``deep_queue_speedup``).

Everything else is compared exactly: completions, decisions, backfills,
utilization, waits, peak queues, the fleet's size, completions and its
serial = parallel verdict, the MILP burst's call count, the windows and
window ratios.  The CSV rows of both carry latencies, so only their names
are compared.  Plus: an engine built on the port's ``DecisionTimer`` takes
the ``rank_window`` route, and the two benches are registered in
``benchmarks_torch.run``.
"""
import json

import pytest
import torch

from benchmarks import bench_scale_curve as j_scale
from benchmarks import bench_streaming as j_stream
from benchmarks_torch import bench_scale_curve as t_scale
from benchmarks_torch import bench_streaming as t_stream
from benchmarks_torch.common import (CLOCK_FIELDS, DEVICE_ENV, DecisionTimer,
                                     drive_stream, provenance)
from repro_torch.core import PolicyPrioritizer, make_policy
from repro_torch.sched import SchedulerEngine, get_scenario

STREAM_JOBS = 300


@pytest.fixture(autouse=True)
def one_thread():
    """torch's threads contend with JAX's in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def masked(doc):
    """``doc`` without the ``CLOCK_FIELDS``, at any depth."""
    if isinstance(doc, dict):
        return {k: masked(v) for k, v in doc.items() if k not in CLOCK_FIELDS}
    if isinstance(doc, list):
        return [masked(v) for v in doc]
    return doc


def run_both(monkeypatch, tmp_path, jmod, tmod, smoke=True, **attrs):
    """Run the reference's ``jmod`` and the port's ``tmod`` with their
    records in ``tmp_path`` (and ``attrs`` set on both modules); returns
    (reference document, port document, reference rows, port rows), the
    documents as written."""
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.setattr(jmod, "JSON_PATH", str(tmp_path / "ref.json"))
    monkeypatch.setattr(tmod, "JSON_PATH", str(tmp_path / "port.json"))
    for k, v in attrs.items():
        monkeypatch.setattr(jmod, k, v)
        monkeypatch.setattr(tmod, k, v)
    rows_ref: list[str] = []
    rows_port: list[str] = []
    kw = {"smoke": True} if smoke else {}
    jmod.run(rows_ref, **kw)
    tmod.run(rows_port, **kw)
    want = json.loads((tmp_path / "ref.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    return want, got, rows_ref, rows_port


def assert_same_doc(got: dict, want: dict) -> None:
    assert masked(got) == masked(want)
    assert got["provenance"]["device"] == "host"
    assert got["provenance"]["card"] is None and "jax" not in got["provenance"]


def test_bench_streaming_matches_reference(monkeypatch, tmp_path):
    want, got, rows_ref, rows_port = run_both(
        monkeypatch, tmp_path, j_stream, t_stream, smoke=False,
        NUM_JOBS=STREAM_JOBS)
    assert_same_doc(got, want)
    assert [r.split(",")[0] for r in rows_port] == \
        [r.split(",")[0] for r in rows_ref]
    assert len(got["results"]) == 7
    for row in got["results"].values():
        assert row["completed"] == STREAM_JOBS and row["decisions"] > 0
    growth = got["deep_queue_latency_growth"]
    assert growth["ref_queue_window"] == 1024 and growth["window_ratio"] == 4.0
    assert got["speedup_vs_pre_pr"] == {}      # baseline only at 10k jobs


def test_bench_scale_curve_matches_reference(monkeypatch, tmp_path):
    want, got, rows_ref, rows_port = run_both(monkeypatch, tmp_path, j_scale,
                                              t_scale)
    assert_same_doc(got, want)
    assert [r.split(",")[0] for r in rows_port] == \
        [r.split(",")[0] for r in rows_ref]
    fleet = got["fleet"]
    assert fleet["serial_parallel_identical"] is True
    assert fleet["total_nodes"] == 1000 and fleet["completed"] == 800
    assert got["gates"]["fleet_serial_parallel_identical"] is True
    assert set(got["window_curve"]) == {"qw1024", "qw2048"}
    assert got["trace_curve"]["jobs1000"]["completed"] == 1000
    assert got["milp_cache"]["calls"] == 200


class CountingFcfs(PolicyPrioritizer):
    def __init__(self):
        super().__init__(make_policy("fcfs"))
        self.calls = {"rank": 0, "rank_window": 0}

    def rank(self, jobs, cluster, now):
        self.calls["rank"] += 1
        return super().rank(jobs, cluster, now)

    def rank_window(self, jobs, cluster, now, fields):
        self.calls["rank_window"] += 1
        return super().rank_window(jobs, cluster, now, fields)


def test_decision_timer_keeps_the_rank_window_route():
    """The engine picks ``rank_window`` up once when it is built: on the
    timer it must find the timer's own, which calls the base's
    ``rank_window`` and never its ``rank``, and the timed stream's schedule
    must be the bare prioritizer's."""
    run = get_scenario("flash-crowd").build(STREAM_JOBS, seed=0)
    base = CountingFcfs()
    pri = DecisionTimer(base)
    timed = SchedulerEngine(run.spec, pri, allocator="pack",
                            fault_model=run.fault_model, queue_window=1024)
    assert timed._rank_window == pri.rank_window
    drive_stream(timed, [j.clone_pending() for j in run.jobs])
    assert base.calls["rank"] == 0
    assert base.calls["rank_window"] == len(pri.lat) > 0
    bare = SchedulerEngine(run.spec, PolicyPrioritizer(make_policy("fcfs")),
                           allocator="pack", fault_model=run.fault_model,
                           queue_window=1024)
    drive_stream(bare, [j.clone_pending() for j in run.jobs])

    def sig(engine):
        return sorted((j.job_id, j.start_time, j.finish_time)
                      for j in engine.completed), engine.decisions
    assert sig(timed) == sig(bare)


def test_host_benches_registered():
    from benchmarks_torch import run as bench_run
    for name in ("streaming", "scale_curve"):
        assert name in bench_run.MODULES


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_host_only_provenance_names_no_card(monkeypatch, device):
    """The host-only benches put no tensor on a device: whatever
    ``--device`` asks for, their records say ``device: host`` and name no
    card."""
    monkeypatch.setenv(DEVICE_ENV, device)
    prov = provenance(seed=0, host_only=True)
    assert prov["device"] == "host"
    assert prov["card"] is None and prov["nvidia_smi"] is None

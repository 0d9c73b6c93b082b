"""The port's observability bundle (tracer, metrics registry, decision
audit log, trace reporter) against the JAX package's (the analog of
``tests/test_obs.py``).

Everything the sinks record on the simulated clock must equal the
reference's exactly: the Prometheus text (metric names ``repro_*`` as the
reference emits them), the trace's job spans and instants, the audit
records and their aggregates.  What they record on the host's wall clock
(control-plane span times, the allocation-latency histogram, ranking
wall seconds) differs from run to run in either package and is masked.
The reporter, given the same document, prints the same report.
"""
import io
import json
import os
import subprocess
import sys

import pytest

import repro.fed as JF
import repro.lifecycle as JL
import repro.obs as JO
import repro.obs.report as j_report
import repro.sched as JS
import repro_torch.fed as TF
import repro_torch.lifecycle as TL
import repro_torch.obs as TO
import repro_torch.obs.report as t_report
import repro_torch.sched as TS
from test_torch_stream import _signature

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = sorted(JS.list_scenarios())

#: Prometheus series whose values are wall-clock latencies
WALL_SERIES = ("repro_alloc_wall_seconds_bucket", "repro_alloc_wall_seconds_sum")
WALL = "<wall>"


def _mask_prometheus(text: str) -> list[str]:
    out = []
    for line in text.splitlines():
        name = line.split("{", 1)[0].split(" ", 1)[0]
        if name in WALL_SERIES:
            line = line.rsplit(" ", 1)[0] + " " + WALL
        out.append(line)
    return out


def _mask_trace(doc: dict) -> dict:
    """Control-plane events carry wall-clock ``ts`` / ``dur``: masked."""
    events = []
    for ev in doc["traceEvents"]:
        if ev.get("cat") == "control":
            ev = dict(ev, ts=WALL, **({"dur": WALL} if "dur" in ev else {}))
        events.append(ev)
    return dict(doc, traceEvents=events)


def _mask_audit(summary: dict) -> dict:
    out = dict(summary, rank_wall_s=WALL)
    if "members" in out:
        out["members"] = {k: _mask_audit(v)
                          for k, v in out["members"].items()}
    return out


def _records(log) -> list[dict]:
    return [dict(r, rank_wall_s=WALL) for r in log.records]


def _model(model: dict, wall=True) -> dict:
    """``analyze``'s model with each ``JobTrack`` as the tuple of its
    fields (the two packages have distinct classes)."""
    jobs = {k: tuple(getattr(t, f) for f in t.__slots__)
            for k, t in model["jobs"].items()}
    return dict(model, jobs=jobs, **({} if wall else {"rank_wall_s": WALL}))


def test_exports_identical():
    assert sorted(TO.__all__) == sorted(JO.__all__)


def _registry_ops(O):
    reg = O.MetricsRegistry()
    reg.counter("repro_x_total", "x", cluster="a").inc()
    reg.counter("repro_x_total", "x", cluster="b").inc(2.5)
    g = reg.gauge("repro_g", "g", cluster="a")
    g.set(3.0)
    g.set(-1.25)
    h = reg.histogram("repro_h_seconds", "h", buckets=(0.1, 1.0, 10.0),
                      cluster="a")
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    other = O.MetricsRegistry()
    other.counter("repro_x_total", "x", cluster="a").inc(4)
    other.histogram("repro_h_seconds", "h", buckets=(0.1, 1.0, 10.0),
                    cluster="a").observe(0.2)
    merged = O.MetricsRegistry.merged([reg, other])
    return (reg.render(), merged.render(),
            merged.value("repro_x_total", cluster="a"),
            merged.value("repro_g", cluster="a"))


def test_registry_primitives_identical():
    assert _registry_ops(TO) == _registry_ops(JO)


def _stream_obs(S, L, O, scenario):
    obs = O.Observability(name=scenario)
    kw = {}
    if scenario == "slo-lanes":
        kw["preemption"] = L.PreemptionController([L.SloDeadlinePolicy(),
                                                   L.ElasticGangPolicy()])
    sr = S.run_scenario(scenario, num_jobs=100, seed=0, allocator="milp",
                        rescan_interval=60.0, obs=obs, **kw)
    return sr, obs


@pytest.mark.parametrize("scenario", ["flash-crowd", "chaos-storm",
                                      "slo-lanes"])
def test_stream_exports_identical(scenario):
    """One stream under the full bundle: the Prometheus text, the trace,
    the audit log and the reporter's model equal the reference's once the
    wall-clock values are masked."""
    jsr, jobs = _stream_obs(JS, JL, JO, scenario)
    tsr, tobs = _stream_obs(TS, TL, TO, scenario)
    assert _signature(tsr.engine) == _signature(jsr.engine)
    prom = tobs.prometheus()
    assert _mask_prometheus(prom) == _mask_prometheus(jobs.prometheus())
    for name in ("repro_decisions_total", "repro_jobs_finished_total",
                 "repro_alloc_wall_seconds_bucket"):
        assert name in prom
    doc = tobs.trace_document()
    assert TO.validate_trace(doc) == []
    assert _mask_trace(doc) == _mask_trace(jobs.trace_document())
    assert _mask_audit(tobs.audit_summary()) == \
        _mask_audit(jobs.audit_summary())
    assert _records(tobs.audit) == _records(jobs.audit)
    model = t_report.analyze(doc)
    want = j_report.analyze(jobs.trace_document())
    assert _model(model, wall=False) == _model(want, wall=False)
    assert sum(model["path_counts"].values()) == tsr.engine.decisions
    if scenario == "slo-lanes":
        assert "repro_preemptions_total" in prom
        ticks = tobs.merged_registry().value(
            "repro_controller_ticks_total", cluster=scenario,
            controller="preemption")
        assert ticks > 0


def test_report_identical_on_one_document(tmp_path, capsys):
    """Given the same trace file, ``analyze``, ``print_report`` and the CLI
    (``main``) give the reference's output, wall-clock lines included."""
    jsr, jobs = _stream_obs(JS, JL, JO, "slo-lanes")
    path = tmp_path / "trace.json"
    jobs.export_trace(str(path))
    doc = json.loads(path.read_text())
    assert _model(t_report.analyze(doc)) == _model(j_report.analyze(doc))
    bufs = [io.StringIO(), io.StringIO()]
    j_report.print_report(doc, top=5, out=bufs[0])
    t_report.print_report(doc, top=5, out=bufs[1])
    assert bufs[1].getvalue() == bufs[0].getvalue()
    assert "critical path" in bufs[1].getvalue()
    outs = []
    for report in (j_report, t_report):
        rc = report.main([str(path), "--validate", "--top", "4"])
        outs.append((rc, capsys.readouterr()))
    assert outs[1][0] == outs[0][0] == 0
    assert outs[1][1].out == outs[0][1].out
    assert "trace OK" in outs[1][1].out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X"}]}))
    for args, rc in (([str(tmp_path / "nope.json")], 2),
                     ([str(bad), "--validate"], 1)):
        got = (t_report.main(args), capsys.readouterr().err)
        want = (j_report.main(args), capsys.readouterr().err)
        assert got[0] == want[0] == rc
        assert got[1] == want[1]


def test_report_module_cli(tmp_path, capsys):
    """``python -m repro_torch.obs.report`` runs as a program and names
    itself so in its usage."""
    obs = TO.Observability(name="t")
    TS.run_scenario("flash-crowd", num_jobs=60, seed=0, obs=obs)
    path = tmp_path / "trace.json"
    obs.export_trace(str(path))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                          str(path), "--validate", "--top", "3"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "trace OK" in out.stdout and "top queueing causes" in out.stdout
    with pytest.raises(SystemExit):
        t_report.main(["--help"])
    assert "python -m repro_torch.obs.report" in capsys.readouterr().out


def test_validate_trace_identical():
    docs = [{"no": "events"}, {"traceEvents": [{"ph": "X"}]},
            {"traceEvents": [{"name": "a", "ph": "Z", "ts": 0, "pid": 1,
                              "tid": 1}]},
            {"traceEvents": [{"name": "a", "ph": "X", "ts": -5.0, "pid": 1,
                              "tid": 1, "dur": 1}]},
            {"traceEvents": [{"name": "a", "ph": "X", "ts": 0.0, "pid": 1,
                              "tid": 1, "dur": 2.0}]}]
    got = [TO.validate_trace(d) for d in docs]
    assert got == [JO.validate_trace(d) for d in docs]
    assert all(got[:4]) and got[4] == []


def _fleet_obs(F, O):
    obs = O.Observability(name="fleet")
    sr = F.run_fleet("fleet-fault-storm", num_jobs=120, seed=3,
                     allocator="pack", obs=obs, parallel=True)
    return sr, obs


def test_fleet_exports_identical():
    """A fleet under one bundle (members stepped serially, as ``obs``
    forces): member trace rows, fleet counters and per-member audit
    summaries equal the reference's."""
    jsr, jobs = _fleet_obs(JF, JO)
    tsr, tobs = _fleet_obs(TF, TO)
    assert [len(m.audit.records) for m in tobs.members()] == \
        [len(m.audit.records) for m in jobs.members()]
    prom = tobs.prometheus()
    assert _mask_prometheus(prom) == _mask_prometheus(jobs.prometheus())
    assert "repro_fed_routed_total" in prom
    doc = tobs.trace_document()
    assert TO.validate_trace(doc) == []
    assert _mask_trace(doc) == _mask_trace(jobs.trace_document())
    assert _mask_audit(tobs.audit_summary()) == \
        _mask_audit(jobs.audit_summary())
    assert len({e["pid"] for e in doc["traceEvents"]
                if e.get("cat") == "job"}) >= 3
    assert tsr.fed._pool is None          # obs keeps the stepping serial


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_obs_off_is_bit_identical_per_scenario(scenario):
    base = TS.run_scenario(scenario, num_jobs=60, seed=1)
    obs = TO.Observability(name=scenario)
    got = TS.run_scenario(scenario, num_jobs=60, seed=1, obs=obs)
    assert _signature(got.engine) == _signature(base.engine)
    assert TO.validate_trace(obs.trace_document()) == []


def test_tracer_and_audit_units_identical():
    """The tracer's finalize / cap paths and the audit ring, driven by the
    same hook calls in both packages."""
    class _J:
        num_gpus = 2
        restarts = 0

    def drive(O):
        tracer = O.SpanTracer(name="x", max_events=6)
        for i in range(10):
            j = _J()
            j.job_id = i
            tracer.on_submit(j, float(i))
            if i % 2:
                tracer.on_start(j, float(i) + 1.0)
        tracer.finalize(100.0)
        log = O.DecisionAuditLog(keep=5)
        for i in range(12):
            log.on_decision_audit(
                {"now": float(i), "path": "policy", "window": 1,
                 "rank_wall_s": 0.0, "top_job": i, "placed": bool(i % 3),
                 "alloc": "heuristic", "skips": {"head-no-placement": 1},
                 "backfills": i % 2})
        log.on_window_blocked(12.0, 3)
        return tracer.to_document(), log.summary(), list(log.records)
    assert drive(TO) == drive(JO)


def test_observability_switches_identical():
    for O in (TO, JO):
        obs = O.Observability(trace=False, metrics=False, audit=False)
        assert obs.hooks() == ()
    o = TO.Observability(name="f")
    o.note_window(0.0, 0.001, 3)
    o.note_controller("autoscaler", 2, 0.002, 60.0)
    assert TO.validate_trace(o.trace_document()) == []
    assert o.merged_registry().value("repro_rescan_windows_total",
                                     cluster="f") == 1.0

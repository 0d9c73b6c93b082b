"""The span recorder inside the port's scheduling pass
(``repro_torch.core.spans``).

Off, it must leave every schedule, logit, predictor answer, counter and
saved state as it is and read no clock; on, every span closes, self times
add up to the passes' walls, children lie inside their parents, the
counters agree with the engine's own, its clock lands on the profiler's
trace, and ``Observability`` exports it while it is on.  Host only;
imports no JAX.
"""
import dataclasses
import json
import pickle

import numpy as np
import pytest
import torch

import repro_torch.sched as TS
from repro_torch.core import spans
from repro_torch.core.agent import PPOAgent, PPOConfig
from repro_torch.core.cluster import ClusterState
from repro_torch.core.env import RLPrioritizer
from repro_torch.core.milp import choose_allocation
from repro_torch.core.policies import make_policy
from repro_torch.core.trace import HELIOS, generate_trace, make_cluster
from repro_torch.core.types import ClusterSpec, NodeSpec
from repro_torch.kernels import ops
from repro_torch.kernels.batch_score import BucketedScorer
from repro_torch.obs import Observability, validate_trace
from repro_torch.predict import RuntimePredictor

SCENARIOS = ("steady", "flash-crowd", "chaos-storm", "mispredict-storm")
CPU = torch.device("cpu")
#: the kernel wrappers as imported, before any test wraps them
OPS = (ops.policy_mlp, ops.predict_mlp)
#: a five-node slice of the Helios cluster, two GPU types
SMALL_NODES = [
    {"count": 2, "gpu_type": "P100", "gpus": 8, "cpus": 64, "mem_gb": 512.0,
     "speed": 1.0},
    {"count": 1, "gpu_type": "V100", "gpus": 8, "cpus": 64, "mem_gb": 512.0,
     "speed": 1.5},
    {"count": 2, "gpu_type": "P100", "gpus": 2, "cpus": 16, "mem_gb": 128.0,
     "speed": 1.0}]
#: jobs in the trace, the backlog at the snapshot, and passes run from it
SMALL_JOBS, SMALL_PENDING, SMALL_PASSES = 800, 300, 60


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.disable()
    yield
    spans.disable()


def _signature(engine):
    """``tests/test_predict.py``'s schedule signature."""
    jobs = tuple(sorted(
        (j.job_id, round(j.submit_time, 6),
         round(j.first_start_time if j.first_start_time is not None else -1,
               6),
         round(j.finish_time if j.finish_time is not None else -1, 6),
         j.restarts)
        for j in engine.completed))
    return jobs, (engine.decisions, engine.milp_calls, engine.backfills,
                  engine.restarts, engine.bf_reservations,
                  engine.bf_overruns)


def _state(engine) -> dict:
    """The engine's saved state, each attribute pickled on its own; the
    prioritizer's torch tensors (whose pickles differ from run to run) as
    their values."""
    state = pickle.loads(engine.save_state())
    pri = state.pop("prioritizer")
    agent = getattr(pri, "agent", None)
    if agent is not None:
        state["actor"] = [t.detach().cpu().numpy()
                          for lyr in agent.params["actor"]
                          for t in lyr.values()]
    else:
        state["prioritizer"] = pri
    return {k: pickle.dumps(v) for k, v in state.items()}


def _scenario(name, on):
    pred = RuntimePredictor(assist=True, seed=0, device="cpu") \
        if name == "mispredict-storm" else None
    if on:
        spans.enable()
    try:
        sr = TS.run_scenario(name, num_jobs=90, seed=1, predictor=pred)
    finally:
        rec = spans.disable() if on else None
    return sr, rec


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_recorder_on_and_off_schedule_alike(scenario):
    off, _ = _scenario(scenario, False)
    on, rec = _scenario(scenario, True)
    assert _signature(on.engine) == _signature(off.engine)
    assert _state(on.engine) == _state(off.engine)
    assert rec.totals["rltune.step"][0] > 0
    assert rec.counters["rank.decisions"] == on.engine.decisions


def test_off_reads_no_clock(monkeypatch):
    def boom():
        raise AssertionError("the recorder read its clock while off")
    monkeypatch.setattr(spans, "_perf", boom)
    sr, _ = _scenario("flash-crowd", False)
    assert sr.engine.decisions > 0


# ---------------------------------------- the engine the benchmark drives --
def benchmark_snapshot(device) -> bytes:
    """A snapshot of an engine built as ``sched.run_stream`` builds one
    for the Helios slice: the greedy actor with the bucketed tail scorer,
    MILP placement, EASY backfill, look-ahead 8, a 2,560-job window and
    the assisted runtime predictor, on ``device``, over five nodes and a
    Helios trace at three times its arrival rate, stepped to a backlog of
    300 jobs."""
    nodes = [NodeSpec(i, n["gpu_type"], n["gpus"], n["cpus"], n["mem_gb"],
                      n["speed"])
             for i, n in enumerate(n for grp in SMALL_NODES
                                   for n in [grp] * grp["count"])]
    agent = PPOAgent(PPOConfig(actor_hidden=(64, 32), seed=5),
                     device=device)
    prioritizer = RLPrioritizer(
        agent, explore=False,
        deep_scorer=BucketedScorer(agent.params["actor"]))
    pred = RuntimePredictor(assist=True, hidden=(24, 12), seed=5,
                            device=device)
    eng = TS.SchedulerEngine(ClusterSpec(nodes=nodes, name="small"),
                             prioritizer, allocator="milp", backfill=True,
                             lookahead_k=8, queue_window=2560, hooks=(pred,),
                             predictor=pred)
    profile = dataclasses.replace(
        HELIOS, arrival_rate=3.0 * HELIOS.arrival_rate)
    eng.submit(generate_trace(profile, SMALL_JOBS, seed=5))
    while len(eng.pending) < SMALL_PENDING:
        assert eng.step(float("inf"), max_events=1) > 0, "the trace ran dry"
    return eng.save_state()


@pytest.fixture(scope="module")
def program():
    torch.set_num_threads(1)
    return benchmark_snapshot(CPU)


def _passes(blob, on, monkeypatch, n=SMALL_PASSES):
    """Restore the snapshot and run ``n`` passes; returns the engine, the
    actor and predictor outputs in call order, and the recorder."""
    outs = {"policy": [], "predict": []}
    policy0, predict0 = OPS

    def policy(x, params, mask):
        out = policy0(x, params, mask)
        outs["policy"].append(out.clone())
        return out

    def predict(x, params):
        out = predict0(x, params)
        outs["predict"].append(out.clone())
        return out

    monkeypatch.setattr(ops, "policy_mlp", policy)
    monkeypatch.setattr(ops, "predict_mlp", predict)
    rec = spans.enable() if on else None
    try:
        eng = TS.SchedulerEngine.load_state(blob)
        calls0, dec0, bf0 = eng.milp_calls, eng.decisions, eng.backfills
        for _ in range(n):
            eng.step(float("inf"), max_events=1)
    finally:
        spans.disable()
    return eng, outs, rec, (eng.milp_calls - calls0, eng.decisions - dec0,
                            eng.backfills - bf0)


def test_benchmark_engine_on_and_off_alike(program, monkeypatch):
    a, outs_a, _, _ = _passes(program, False, monkeypatch)
    b, outs_b, rec, _ = _passes(program, True, monkeypatch)
    assert _signature(b) == _signature(a)
    assert [j.job_id for j in b.pending] == [j.job_id for j in a.pending]
    assert _state(b) == _state(a)
    for k in ("policy", "predict"):
        assert len(outs_a[k]) == len(outs_b[k]) > 0
        for x, y in zip(outs_a[k], outs_b[k]):
            assert torch.equal(x, y)
    for name in ("rltune.rank.features", "rltune.rank.actor",
                 "rltune.rank.tail", "rltune.backfill",
                 "rltune.predict.rows", "rltune.predict.forward"):
        assert rec.totals[name][0] > 0, name


def test_spans_nest_and_close(program, monkeypatch):
    _, _, rec, _ = _passes(program, True, monkeypatch)
    assert rec.depth == 0 and rec.dropped == 0
    ev = sorted(rec.events, key=lambda e: (e[0], -e[1]))
    # every span lies inside the span one level up that was open at its start
    stack = []
    for s, e, nid, d in ev:
        while stack and stack[-1][1] <= s and stack[-1][3] >= d:
            stack.pop()
        while stack and stack[-1][3] >= d:
            stack.pop()
        if d == 0:
            assert rec.names[nid] == "rltune.step"
        else:
            parent = stack[-1]
            assert parent[3] == d - 1
            assert parent[0] <= s and e <= parent[1]
        stack.append((s, e, nid, d))
    walls = sum(e - s for s, e, nid, d in ev if d == 0)
    assert walls == rec.totals["rltune.step"][1]
    selfs = sum(t[2] for t in rec.totals.values())
    assert abs(selfs - walls) <= 0.01 * walls
    for t in rec.totals.values():
        assert 0 <= t[2] <= t[1]


def test_counters_agree_with_the_engine(program, monkeypatch):
    _, _, rec, (calls, decisions, backfills) = _passes(program, True,
                                                       monkeypatch)
    c = rec.counters
    assert c.get("milp.hits", 0) + c.get("milp.solves", 0) \
        + c.get("milp.greedy", 0) == calls
    assert c["rank.decisions"] == decisions > 0
    assert 0 <= c["rank.futile"] <= c["rank.decisions"]
    assert c["backfill.tried"] - c["backfill.failed"] == backfills > 0
    assert c["backfill.failed"] >= 0
    assert c["predict.param_uploads"] > 0
    # every ranking builds its features once, from the window's shape ids
    assert c["rank.shape_path"] == decisions
    assert c["rank.shape_path"] <= c["rank.shape_evals"]
    assert set(c) <= {"rank.decisions", "rank.futile", "milp.hits",
                      "milp.solves", "milp.greedy", "backfill.tried",
                      "backfill.failed", "predict.param_uploads",
                      "rank.shape_path", "rank.shape_evals"}
    # a CPU engine copies nothing to a card
    assert not any(k.startswith("device.") for k in c)


def test_milp_counters_by_path():
    cluster = ClusterState(make_cluster("helios"))
    for job in generate_trace("helios", 200, seed=3):
        # fill the cluster until a job can be spread or packed
        ways = cluster.candidate_ways(job)
        if len(ways) > 1:
            break
        if ways:
            cluster.allocate(job, ways[0])
    assert len(ways) > 1
    rec = spans.enable()
    choose_allocation(cluster, job, ways)                 # HiGHS
    choose_allocation(cluster, job, ways)                 # the cache
    choose_allocation(cluster, job, ways, use_solver=False)
    choose_allocation(cluster, job, ways[:1])             # one way: none
    assert rec.counters == {"milp.solves": 1, "milp.hits": 1,
                            "milp.greedy": 1}
    assert rec.totals["rltune.milp.solve"][0] == 1


def test_foreign_threads_count_but_do_not_nest():
    import threading
    rec = spans.enable()
    rec.open("rltune.step")

    def work():
        rec.open("rltune.rank")
        rec.count("rank.decisions")
        rec.close()
    t = threading.Thread(target=work)
    t.start()
    t.join()
    rec.close()
    assert list(rec.totals) == ["rltune.step"]
    assert rec.foreign == 1 and rec.counters == {"rank.decisions": 1}


# ------------------------------------------------------------------- clock --
def test_clock_lands_on_the_profiler_trace(tmp_path):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        # the profiler's first range pays its set-up; the anchor's is warm
        with torch.profiler.record_function("warm"):
            pass
        rec = spans.enable()
        with torch.profiler.record_function("outer"):
            rec.open("rltune.step")
            sum(range(20000))
            rec.close()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    ev = {e["name"]: e for e in doc["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    anchor, outer = ev["rltune.anchor"], ev["outer"]
    base = doc.get("baseTimeNanoseconds")
    # through time.time_ns(): the reading inside the anchor lands in it
    at = rec.trace_us(rec.anchor["profiler_perf_ns"], None, base)
    assert anchor["ts"] - 50 <= at <= anchor["ts"] + anchor["dur"] + 50
    # through the anchor: the span lands inside the range around it
    s, e, _, _ = rec.events[0]
    end = anchor["ts"] + anchor["dur"]
    assert outer["ts"] - 50 <= rec.trace_us(s, end, base)
    assert rec.trace_us(e, end, base) <= outer["ts"] + outer["dur"] + 50


def test_engine_follows_the_profiler():
    spec = make_cluster("helios")
    pri = TS.PolicyPrioritizer(make_policy("fcfs"))
    jobs = generate_trace("helios", 40, seed=0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        eng = TS.SchedulerEngine(spec, pri)
        rec = spans.ACTIVE
        assert rec is not None and rec.follows_profiler
        eng.submit(jobs)
        eng.step(float("inf"), max_events=5)
        assert spans.ACTIVE is rec
    steps = rec.totals["rltune.step"][0]
    assert steps == 5
    # the first step after the profiler stopped switches the recorder off
    # and records nothing
    assert spans.ACTIVE is rec
    eng.step(float("inf"), max_events=5)
    assert spans.ACTIVE is None and spans.LAST is rec
    assert rec.totals["rltune.step"][0] == steps
    # and so does a build or restore
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        TS.SchedulerEngine.load_state(eng.save_state())
        assert spans.ACTIVE is not None
    TS.SchedulerEngine.load_state(eng.save_state())
    assert spans.ACTIVE is None
    # a recorder switched on by hand stays on, profiler or not
    mine = spans.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        eng = TS.SchedulerEngine(spec, pri)
    eng.submit(generate_trace("helios", 10, seed=1))
    eng.drain()
    assert spans.ACTIVE is mine and not mine.follows_profiler
    assert mine.totals["rltune.step"][0] > 0


# ------------------------------------------------------------------ bundle --
def test_observability_exports_the_spans(tmp_path):
    obs = Observability(name="t")
    rec = spans.enable()
    pred = RuntimePredictor(assist=True, seed=0, device="cpu")
    TS.run_scenario("flash-crowd", num_jobs=60, seed=0, obs=obs,
                    predictor=pred)
    obs.finalize()
    doc = obs.trace_document()
    assert validate_trace(doc) == []
    mine = [e for e in doc["traceEvents"] if e.get("cat") == "span"]
    assert len(mine) == len(rec.events) > 0
    assert {e["pid"] for e in mine} == {obs.tracer.ctrl_pid}
    text = obs.prometheus()
    assert 'repro_span_seconds_total{span="rltune.step"}' in text
    assert 'repro_span_calls_total{span="rltune.rank"}' in text
    assert "repro_rank_decisions_total" in text
    assert "repro_predict_param_uploads_total" in text
    path = tmp_path / "trace.json"
    obs.export_trace(str(path))
    from repro_torch.obs import report
    assert report.main([str(path), "--validate"]) == 0
    # off again: the views carry nothing of it
    spans.disable()
    assert "repro_span_" not in obs.prometheus()
    assert not any(e.get("cat") == "span"
                   for e in obs.trace_document()["traceEvents"])


def test_bundle_default_is_off():
    obs = Observability(name="t")
    TS.run_scenario("flash-crowd", num_jobs=30, seed=0, obs=obs)
    assert spans.ACTIVE is None
    text = obs.prometheus()
    assert "repro_span_" not in text
    assert not any(e.get("cat") == "span"
                   for e in obs.trace_document()["traceEvents"])
    assert np.isfinite(obs.wall_elapsed_s)

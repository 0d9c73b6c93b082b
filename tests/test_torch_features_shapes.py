"""The port's feature build over the engine's shape-id column.

``_build_features_vec`` queries the cluster once per distinct job shape in
the window (the engine's ``_PendingFieldIndex`` interns the shapes) and
gathers the answers to rows.  Held here bit for bit against the scalar
reference ``_build_features_scalar`` on the same ``Job`` list: engine
windows with many shapes, sub-windows, ``from_jobs``, restored engines,
clusters with faulted and drained nodes, and whole engine runs.  Host
only; imports no JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.sched as TS
from repro_torch.core import spans
from repro_torch.core.agent import PPOAgent, PPOConfig
from repro_torch.core.cluster import ClusterState, _job_shape
from repro_torch.core.env import RLPrioritizer
from repro_torch.core.features import (_build_features_scalar,
                                       build_features, build_state)
from repro_torch.core.policies import make_policy
from repro_torch.core.prioritizer import PolicyPrioritizer, WindowFields
from repro_torch.core.trace import HELIOS, generate_trace, make_cluster
from repro_torch.core.types import Job
from repro_torch.kernels import ops
from repro_torch.kernels.batch_score import BucketedScorer

SPEC = make_cluster("helios")
#: the actor's kernel wrapper as imported, before any test wraps it
POLICY_MLP = ops.policy_mlp
#: the engine's ranking window; the backlog behind it holds more shapes
WINDOW = 160


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.disable()
    yield
    spans.disable()


def _varied_jobs(n, seed, first_id=0, cpu_step=1):
    """A Helios trace whose CPU and memory requests vary per job, as a CSV
    trace's can: many more shapes than ``num_gpus`` x ``gpu_type``."""
    jobs = generate_trace("helios", n, seed=seed)
    for k, j in enumerate(jobs):
        j.job_id = first_id + k
        j.req_cpus = max(1, 4 * j.num_gpus) + cpu_step * (k % 7)
        j.req_mem_gb = 32.0 * j.num_gpus + 8.0 * (k % 5)
    return jobs


def _backlog_engine():
    """An FCFS engine on the Helios slice whose jobs all arrive within a
    few minutes and run for days: the cluster fills and the rest wait."""
    jobs = _varied_jobs(420, seed=3)
    for k, j in enumerate(jobs):
        j.submit_time = float(k)
        j.runtime = j.est_runtime = 5e5 + k
    eng = TS.SchedulerEngine(SPEC, PolicyPrioritizer(make_policy("fcfs")),
                             allocator="pack", queue_window=WINDOW)
    eng.submit(jobs)
    eng.step(jobs[-1].submit_time)
    assert len(eng.pending) > 2 * WINDOW
    return eng


def _non_finite_engine():
    """The backlog engine over a trace with corrupt fields: infinite run
    times, NaN estimates and NaN memory requests, which both feature paths'
    guard maps to finite features."""
    jobs = _varied_jobs(420, seed=5)
    nan = float("nan")
    for k, j in enumerate(jobs):
        j.submit_time = float(k)
        j.runtime = j.est_runtime = 5e5 + k
        if k % 11 == 0:
            j.runtime = float("inf")
        if k % 13 == 0:
            j.est_runtime = nan
        if k % 17 == 0:
            j.req_mem_gb = nan
    eng = TS.SchedulerEngine(SPEC, PolicyPrioritizer(make_policy("fcfs")),
                             allocator="pack", queue_window=WINDOW)
    eng.submit(jobs)
    eng.step(jobs[-1].submit_time)
    return eng


def _window(eng):
    w = min(eng.queue_window, len(eng.pending))
    return eng.pending[:w], eng._pindex.window(eng.queue_window)


def _restored(new_shapes):
    eng = TS.SchedulerEngine.load_state(_backlog_engine().save_state())
    if new_shapes:
        # jobs whose CPU requests no job had before, submitted early
        # enough to sort into the window
        fresh = _varied_jobs(40, seed=9, first_id=10_000, cpu_step=3)
        for k, j in enumerate(fresh):
            j.submit_time = 0.5 + k
            j.runtime = j.est_runtime = 5e5
        eng.submit(fresh)
        eng.step(eng.now)
    return eng


def _fields_case(case):
    """(jobs, fields) for one way of building the window's fields."""
    if case == "engine":
        jobs, f = _window(_backlog_engine())
        # more than 40 shapes in the window, and shapes only the backlog
        # behind it has in the engine's table
        assert len(np.unique(f.shape)) > 40
        assert len(f.shapes) > len(np.unique(f.shape))
        return jobs, f
    if case == "take":
        jobs, f = _window(_backlog_engine())
        ix = list(range(len(jobs) - 1, -1, -3))
        return [jobs[i] for i in ix], f.take(ix)
    if case == "from_jobs":
        jobs, _ = _window(_backlog_engine())
        return jobs, WindowFields.from_jobs(jobs)
    if case == "non_finite":
        jobs, f = _window(_non_finite_engine())
        assert not np.isfinite(f.runtime).all()
        return jobs, f
    if case == "restored":
        return _window(_restored(False))
    if case == "restored_new_shapes":
        before = _restored(False)
        eng = _restored(True)
        jobs, f = _window(eng)
        assert len(f.shapes) > len(before._pindex.shapes.shapes)
        assert any(j.job_id >= 10_000 for j in jobs)
        return jobs, f
    raise ValueError(case)


def _cluster_case(case, eng_cluster=None):
    if case == "busy":
        return eng_cluster
    c = ClusterState(SPEC, cache=True)
    # about half the GPUs taken, unevenly
    for j in _varied_jobs(30, seed=4):
        pl = c.find_placement(j, "pack")
        if pl is not None and int(c.free_gpus.sum()) > 40:
            c.allocate(j, pl)
    # CPU hogs on the V100 nodes: GPUs stay free there, but too few CPUs
    # for the window's jobs, so V100 shapes fail in the placement search
    hog = Job(job_id=-1, user=0, submit_time=0.0, runtime=1.0,
              est_runtime=1.0, num_gpus=1, gpu_type="V100", req_cpus=60,
              req_mem_gb=1.0)
    for i in np.flatnonzero(c.gpu_types == "V100"):
        if c.free_cpus[i] >= 60 and c.free_gpus[i] >= 1:
            c.allocate(hog, {int(i): 1})
    if case == "faulted":
        c.fail_node(0)
        busy = int(np.flatnonzero(c.free_gpus < c.total_gpus)[-1])
        assert not c.remove_node(busy)          # busy: cordoned
        idle = int(np.flatnonzero((c.free_gpus == c.total_gpus)
                                  & ~c.node_down)[-1])
        assert c.remove_node(idle)              # idle: retired
        assert c.cordoned.any() and c.retired.any() and c.node_down.any()
    return c


FIELDS_CASES = ("engine", "take", "from_jobs", "non_finite", "restored",
                "restored_new_shapes")
CLUSTER_CASES = ("busy", "half", "faulted")


@pytest.mark.parametrize("cluster_case", CLUSTER_CASES)
@pytest.mark.parametrize("fields_case", FIELDS_CASES)
def test_shape_route_matches_the_scalar_loop(fields_case, cluster_case):
    jobs, f = _fields_case(fields_case)
    c = _cluster_case(cluster_case, _backlog_engine().cluster)
    now = max(j.submit_time for j in jobs) + 321.5
    for use_est in (False, True):
        ref = _build_features_scalar(jobs, c, now, use_estimates=use_est)
        got = build_features(jobs, c, now, use_estimates=use_est, fields=f)
        assert got.dtype == ref.dtype
        assert np.array_equal(got, ref)
        for raw in (False, True):
            a = build_state(jobs, c, now, use_estimates=use_est, raw=raw)
            b = build_state(jobs, c, now, use_estimates=use_est, raw=raw,
                            fields=f)
            for x, y in zip(a, b):
                assert np.array_equal(x, y)


def test_the_cases_reach_every_ways_branch():
    """Across the cluster cases some shapes place and some do not: both by
    the free-GPU tally and by the placement search (CPU or memory)."""
    jobs, f = _fields_case("engine")
    seen = set()
    for case in CLUSTER_CASES:
        c = _cluster_case(case, _backlog_engine().cluster)
        for s in set(f.shapes[i] for i in np.unique(f.shape)):
            short = c.free_gpus_of_type(s.gpu_type) < s.num_gpus
            ways = c.num_ways_to_schedule(s)
            seen.add("short" if short else "placed" if ways else "searched")
    assert seen == {"short", "placed", "searched"}


def test_misaligned_jobs_fall_back_to_the_scalar_loop():
    jobs, f = _window(_backlog_engine())
    c = _cluster_case("half")
    rec = spans.enable()
    for short in (jobs[:-1], jobs + jobs[:1]):
        got = build_features(short, c, 1e4, fields=f)
        assert np.array_equal(got, _build_features_scalar(short, c, 1e4))
    assert "rank.shape_path" not in rec.counters


def test_shape_counters_only_while_recording():
    jobs, f = _window(_backlog_engine())
    c = _cluster_case("half")
    build_features(jobs, c, 1e4, fields=f)
    assert spans.ACTIVE is None
    rec = spans.enable()
    build_features(jobs, c, 1e4, fields=f)
    build_state(jobs[:50], c, 1e4, fields=f.take(list(range(50))))
    spans.disable()
    build_features(jobs, c, 1e4, fields=f)
    distinct = len({_job_shape(j) for j in jobs})
    distinct50 = len({_job_shape(j) for j in jobs[:50]})
    assert distinct == len(np.unique(f.shape)) > distinct50
    assert rec.counters == {"rank.shape_path": 2,
                            "rank.shape_evals": distinct + distinct50}
    assert rec.totals == {}


def _engine_run(fields_route, monkeypatch):
    """Orders, starts and actor logits of an engine as the benchmark builds
    one (greedy actor with the bucketed tail, MILP, backfill) over a
    backlog deeper than the actor's 256 rows, with per-job CPU and memory
    requests.  ``fields_route=False`` forces ``rank`` (the scalar loop)."""
    logits = []

    def policy(x, params, mask):
        out = POLICY_MLP(x, params, mask)
        logits.append(out.clone())
        return out

    monkeypatch.setattr(ops, "policy_mlp", policy)
    orders = []

    class Orders(TS.EngineHooks):
        def on_decision(self, jobs, order, now, engine):
            orders.append((now, [jobs[i].job_id for i in order]))

    agent = PPOAgent(PPOConfig(actor_hidden=(64, 32), seed=7),
                     device=torch.device("cpu"))
    pri = RLPrioritizer(agent, explore=False,
                        deep_scorer=BucketedScorer(agent.params["actor"]))
    eng = TS.SchedulerEngine(SPEC, pri, allocator="milp", backfill=True,
                             lookahead_k=8, queue_window=400,
                             hooks=(Orders(),))
    if not fields_route:
        eng._rank_window = None
    profile = dataclasses.replace(HELIOS,
                                  arrival_rate=5.0 * HELIOS.arrival_rate)
    jobs = generate_trace(profile, 700, seed=8)
    for k, j in enumerate(jobs[::2]):
        j.req_cpus = max(1, 4 * j.num_gpus) + k % 5
    eng.submit(jobs)
    deepest = 0
    for _ in range(900):
        if eng.step(float("inf"), max_events=1) == 0:
            break
        deepest = max(deepest, len(eng.pending))
    starts = sorted((j.job_id, j.first_start_time) for j in jobs
                    if j.first_start_time >= 0)
    return orders, starts, logits, deepest


def test_engine_run_matches_the_scalar_route(monkeypatch):
    torch.set_num_threads(1)
    o_a, s_a, l_a, deep = _engine_run(True, monkeypatch)
    o_b, s_b, l_b, _ = _engine_run(False, monkeypatch)
    assert deep > 256 and len(o_a) > 50 and len(s_a) > 50
    assert o_a == o_b
    assert s_a == s_b
    assert len(l_a) == len(l_b)
    assert all(torch.equal(x, y) for x, y in zip(l_a, l_b))

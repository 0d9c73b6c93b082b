"""Parity of the port's host foundation (repro_torch.core / sched) with the
JAX package's: traces, clusters, features, base policies, MILP placement
and the event loop must agree exactly (bit for bit), because the port
carries that numpy/scipy code over unchanged."""
import dataclasses
import os

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.core.cluster import ClusterState as JClusterState
from repro.core.features import build_features as j_build_features
from repro.core.features import build_state as j_build_state
from repro.core.prioritizer import WindowFields as JWindowFields
from repro_torch.core.cluster import ClusterState as TClusterState
from repro_torch.core.features import build_features as t_build_features
from repro_torch.core.features import build_state as t_build_state
from repro_torch.core.prioritizer import WindowFields as TWindowFields

TRACES = ("philly", "helios", "alibaba")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the run_batch configurations of tests/test_sched.py::SEED_GOLDENS:
# (trace, jobs, seed, policy, allocator, backfill, faults)
BATCH_KEYS = [
    ("helios", 96, 0, "fcfs", "milp", True, False),
    ("helios", 96, 0, "sjf", "pack", False, False),
    ("philly", 64, 3, "fcfs", "pack", True, True),
    ("alibaba", 80, 5, "wfp3", "spread", True, False),
]


def job_tuple(job) -> tuple:
    """Every field of a Job, with the state enum by name (the two packages
    have distinct enum classes)."""
    return tuple((f.name, getattr(job, f.name).name
                  if f.name == "state" else getattr(job, f.name))
                 for f in dataclasses.fields(job))


def result_tuple(r) -> tuple:
    return (r.makespan, r.total_wait, r.gpu_seconds_used, r.decisions,
            r.milp_calls, r.backfills, r.restarts)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("trace", TRACES)
def test_generate_trace_identical(trace, seed):
    a = J.generate_trace(trace, 200, seed=seed)
    b = T.generate_trace(trace, 200, seed=seed)
    assert [job_tuple(j) for j in a] == [job_tuple(j) for j in b]


@pytest.mark.parametrize("trace", TRACES)
def test_make_cluster_identical(trace):
    a, b = J.make_cluster(trace), T.make_cluster(trace)
    assert a.name == b.name
    assert [dataclasses.astuple(n) for n in a.nodes] == \
        [dataclasses.astuple(n) for n in b.nodes]


def test_load_trace_csv_identical():
    path = os.path.join(REPO, "src", "repro", "sched", "data",
                        "trace_small.csv")
    a, b = J.load_trace_csv(path), T.load_trace_csv(path)
    assert len(a) > 0
    assert [job_tuple(j) for j in a] == [job_tuple(j) for j in b]


def _busy_clusters(trace: str, seed: int):
    """The same partly-allocated cluster in both packages."""
    jc = JClusterState(J.make_cluster(trace), cache=True)
    tc = TClusterState(T.make_cluster(trace), cache=True)
    fillers_j = J.generate_trace(trace, 12, seed=seed + 100)
    fillers_t = T.generate_trace(trace, 12, seed=seed + 100)
    for fj, ft in zip(fillers_j, fillers_t):
        pj, pt = jc.find_placement(fj, "pack"), tc.find_placement(ft, "pack")
        assert pj == pt
        if pj:
            jc.allocate(fj, pj)
            tc.allocate(ft, pt)
    return jc, tc


@pytest.mark.parametrize("use_est", [False, True])
@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("trace", TRACES)
def test_build_state_identical(trace, raw, use_est):
    """Scalar path and WindowFields path, raw and engineered features."""
    jc, tc = _busy_clusters(trace, 1)
    jobs_j = J.generate_trace(trace, 300, seed=2)
    jobs_t = T.generate_trace(trace, 300, seed=2)
    now = jobs_j[150].submit_time
    for fields_j, fields_t in ((None, None),
                               (JWindowFields.from_jobs(jobs_j),
                                TWindowFields.from_jobs(jobs_t))):
        a = j_build_state(jobs_j, jc, now, use_estimates=use_est, raw=raw,
                          fields=fields_j)
        b = t_build_state(jobs_t, tc, now, use_estimates=use_est, raw=raw,
                          fields=fields_t)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            assert np.array_equal(x, y)
    fa = j_build_features(jobs_j, jc, now, use_estimates=use_est)
    fb = t_build_features(jobs_t, tc, now, use_estimates=use_est)
    assert np.array_equal(fa, fb)


@pytest.mark.parametrize("name", sorted(J.BASE_POLICIES))
def test_base_policy_scores_identical(name):
    jobs_j = J.generate_trace("philly", 128, seed=4)
    jobs_t = T.generate_trace("philly", 128, seed=4)
    now = jobs_j[-1].submit_time
    pj, pt = J.make_policy(name), T.make_policy(name)
    assert [pj.score(j, now) for j in jobs_j] == \
        [pt.score(j, now) for j in jobs_t]


def _mk(pkg, i, gpus, cpus=0, mem=0.0):
    return pkg.Job(job_id=i, user=0, submit_time=0, runtime=100,
                   est_runtime=100, num_gpus=gpus, req_cpus=cpus,
                   req_mem_gb=mem)


def test_choose_allocation_identical():
    """Random cluster states, job shapes and look-ahead depths: the MILP
    (scipy HiGHS) picks the same placement, objective and look-ahead set."""
    rng = np.random.default_rng(42)
    solved = 0
    for trace in TRACES:
        for _ in range(10):
            jc = JClusterState(J.make_cluster(trace))
            tc = TClusterState(T.make_cluster(trace))
            for i in range(int(rng.integers(0, 6))):
                g, cpus = int(rng.integers(1, 8)), int(rng.integers(0, 16))
                mem = float(rng.integers(0, 64))
                fj, ft = _mk(J, 1000 + i, g, cpus, mem), _mk(T, 1000 + i, g,
                                                             cpus, mem)
                pl = jc.find_placement(fj, "pack")
                assert pl == tc.find_placement(ft, "pack")
                if pl:
                    jc.allocate(fj, pl)
                    tc.allocate(ft, pl)
            g, cpus = int(rng.integers(1, 17)), int(rng.integers(0, 32))
            mem = float(rng.integers(0, 128))
            jj, tj = _mk(J, 0, g, cpus, mem), _mk(T, 0, g, cpus, mem)
            ways_j, ways_t = jc.candidate_ways(jj), tc.candidate_ways(tj)
            assert ways_j == ways_t
            if not ways_j:
                continue
            look = [int(rng.integers(1, 9)) for _ in range(int(rng.integers(0, 5)))]
            a = J.choose_allocation(jc, jj, ways_j,
                                    lookahead=[_mk(J, 10 + i, g_) for i, g_ in enumerate(look)])
            b = T.choose_allocation(tc, tj, ways_t,
                                    lookahead=[_mk(T, 10 + i, g_) for i, g_ in enumerate(look)])
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
            solved += a.used_solver
    assert solved >= 5


@pytest.mark.parametrize("optimized", [True, False])
@pytest.mark.parametrize("key", BATCH_KEYS, ids=str)
def test_run_batch_identical(key, optimized):
    """The event loop's aggregates equal the reference computed live (not
    the SEED_GOLDENS literals, one of which scipy 1.17 no longer meets)."""
    trace, n, seed, policy, allocator, backfill, faults = key
    out = []
    for pkg in (J, T):
        fm = pkg.FaultModel(mtbf_per_node=3 * 3600.0, repair_time=600.0,
                            seed=1) if faults else None
        sim = pkg.Simulator(pkg.make_cluster(trace), allocator=allocator,
                            backfill=backfill, fault_model=fm,
                            optimized=optimized)
        r = sim.run_batch(pkg.generate_trace(trace, n, seed=seed),
                          pkg.PolicyPrioritizer(pkg.make_policy(policy)))
        out.append((result_tuple(r),
                    sorted((j.job_id, j.start_time, j.finish_time)
                           for j in r.jobs)))
    assert out[0] == out[1]


def test_engine_save_load_resumes_identically():
    """save_state mid-stream, load_state, drain: the same schedule as an
    uninterrupted run of the port's engine."""
    from repro_torch.sched import SchedulerEngine

    spec = T.make_cluster("helios")
    jobs = T.generate_trace("helios", 120, seed=5)

    def engine():
        e = SchedulerEngine(spec, T.PolicyPrioritizer(T.make_policy("sjf")),
                            allocator="pack")
        e.submit([j.clone_pending() for j in jobs])
        return e

    whole = engine()
    whole.drain()
    part = engine()
    part.step(jobs[60].submit_time)
    resumed = SchedulerEngine.load_state(part.save_state())
    resumed.drain()
    assert sorted((j.job_id, j.finish_time) for j in resumed.completed) == \
        sorted((j.job_id, j.finish_time) for j in whole.completed)

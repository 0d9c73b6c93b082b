"""The port's preemption controller and migration policy against the JAX
package's (the analog of ``tests/test_lifecycle.py``).

Both are host numpy over the engine's lifecycle entry points, so every job
field, every controller event and every telemetry counter must equal the
reference's exactly.  An attached controller with no policies must leave a
stream as it is with ``preemption=None``; a migration policy that can never
clear its threshold must leave a fleet as it is with ``migration=None``; and
``save_state`` / ``load_state`` must restore an engine that a controller has
preempted and resized mid-stream.
"""
import dataclasses
import math

import pytest

import repro.fed as JF
import repro.lifecycle as JL
import repro.sched as JS
import repro_torch.fed as TF
import repro_torch.lifecycle as TL
import repro_torch.sched as TS
from repro.core import PolicyPrioritizer as JPolicyPrioritizer
from repro.core import make_policy as j_make_policy
from repro.core.types import ClusterSpec as JClusterSpec
from repro.core.types import Job as JJob
from repro.core.types import NodeSpec as JNodeSpec
from repro_torch.core import PolicyPrioritizer, make_policy
from repro_torch.core.types import ClusterSpec, Job, NodeSpec
from test_torch_stream import _job_tuple, _signature

SCENARIOS = sorted(JS.list_scenarios())

#: the controller configurations of ``benchmarks/bench_preemption.py``
CONTROLLERS = {
    "slo": lambda L: L.PreemptionController([L.SloDeadlinePolicy()]),
    "slo+elastic": lambda L: L.PreemptionController(
        [L.SloDeadlinePolicy(), L.ElasticGangPolicy()]),
}


def _events(events) -> list[tuple]:
    return [dataclasses.astuple(e) for e in events]


def _tel_counts(tel) -> tuple:
    return (tel.preempt_count, tel.resume_count, tel.resume_penalty_gpu_s,
            _events(tel.preemption_events))


def test_exports_identical():
    assert sorted(TL.__all__) == sorted(JL.__all__)
    for name in ("PreemptionEvent", "MigrationEvent"):
        assert [f.name for f in dataclasses.fields(getattr(TL, name))] == \
            [f.name for f in dataclasses.fields(getattr(JL, name))]
    want, got = JL.ElasticGangPolicy(), TL.ElasticGangPolicy()
    assert vars(got) == vars(want)
    assert vars(TL.SloDeadlinePolicy()) == vars(JL.SloDeadlinePolicy())
    assert vars(TL.QueueImbalanceMigration()) == \
        vars(JL.QueueImbalanceMigration())


@pytest.mark.parametrize("controller", sorted(CONTROLLERS))
def test_slo_lanes_controller_identical(controller):
    """``slo-lanes`` at the preemption bench's settings (``pack``, rescan
    60 s): every job field, the controller's event list and the telemetry's
    preemption counters equal the reference's, and the controller acted."""
    out = []
    for S, L in ((JS, JL), (TS, TL)):
        ctl = CONTROLLERS[controller](L)
        sr = S.run_scenario("slo-lanes", num_jobs=200, seed=0,
                            allocator="pack", rescan_interval=60.0,
                            preemption=ctl)
        out.append((sorted(_job_tuple(j) for j in sr.batch.jobs),
                    _signature(sr.engine), _events(ctl.events),
                    ctl.event_counts(), _tel_counts(sr.telemetry),
                    sr.engine.preemptions, sr.engine.resume_penalty_gpu_s,
                    sr.windows))
    assert out[1] == out[0]
    counts = out[1][3]
    assert counts.get("preempt", 0) > 0 and counts.get("deadline-start", 0) > 0
    if controller == "slo+elastic":
        assert counts.get("shrink", 0) + counts.get("grow", 0) > 0


def _one_node_engine(pkg_types, pri, engine_cls, gpus=8):
    C, N = pkg_types
    spec = C([N(0, "P100", gpus, 4 * gpus * 4, 32.0 * gpus * 4, 1.0)],
             name="uni")
    return engine_cls(spec, pri, allocator="pack")


def _unit_case(J, C, N, pri, engine_cls, L):
    """``tests/test_lifecycle.py``'s single-node cases: an SLO eviction for
    two deadline jobs, then an elastic shrink under backlog and a grow when
    idle.  Returns every event and every job's fields."""
    eng = _one_node_engine((C, N), pri(), engine_cls)
    eng.submit([J(job_id=0, user=0, submit_time=0.0, runtime=50_000.0,
                  est_runtime=50_000.0, num_gpus=8),
                J(job_id=1, user=0, submit_time=50.0, runtime=1000.0,
                  est_runtime=1000.0, num_gpus=4, deadline=2000.0),
                J(job_id=2, user=0, submit_time=60.0, runtime=1000.0,
                  est_runtime=1000.0, num_gpus=4, deadline=2100.0)])
    eng.step(600.0)
    ctl = L.PreemptionController([L.SloDeadlinePolicy()])
    ctl.control(eng, 600.0)
    eng.drain()
    slo = (_events(ctl.events), sorted(_job_tuple(j) for j in eng.completed),
           eng.preemptions, eng.resume_penalty_gpu_s)

    eng = _one_node_engine((C, N), pri(), engine_cls)
    eng.submit([J(job_id=0, user=0, submit_time=0.0, runtime=40_000.0,
                  est_runtime=40_000.0, num_gpus=8, min_gpus=2, max_gpus=8),
                J(job_id=1, user=0, submit_time=10.0, runtime=1000.0,
                  est_runtime=1000.0, num_gpus=4)])
    eng.step(60.0)
    pol = L.ElasticGangPolicy()
    ev = pol.tick(eng, 60.0, L.CkptCostModel())
    eng.reschedule(at=60.0)
    eng.step(20_000.0)
    ev2 = pol.tick(eng, 20_000.0, L.CkptCostModel())
    eng.drain()
    elastic = (_events(ev), _events(ev2),
               sorted(_job_tuple(j) for j in eng.completed))
    return slo, elastic


def test_single_node_policies_identical():
    want = _unit_case(JJob, JClusterSpec, JNodeSpec,
                      lambda: JPolicyPrioritizer(j_make_policy("fcfs")),
                      JS.SchedulerEngine, JL)
    got = _unit_case(Job, ClusterSpec, NodeSpec,
                     lambda: PolicyPrioritizer(make_policy("fcfs")),
                     TS.SchedulerEngine, TL)
    assert got == want
    (slo_events, *_), (shrink, grow, _) = got
    assert [e[1] for e in slo_events] == \
        ["preempt", "deadline-start", "deadline-start"]
    assert [e[1] for e in shrink] == ["shrink"]
    assert [e[1] for e in grow] == ["grow"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_disabled_preemption_bit_identical(name):
    """An attached controller with no policies is unobservable: the same
    signature and telemetry as ``preemption=None`` on every scenario."""
    base = TS.run_scenario(TS.get_scenario(name).build(64, seed=5),
                           allocator="pack", rescan_interval=300.0)
    inert = TS.run_scenario(TS.get_scenario(name).build(64, seed=5),
                            allocator="pack", rescan_interval=300.0,
                            preemption=TL.PreemptionController(policies=[]))
    assert _signature(inert.engine) == _signature(base.engine)
    assert [dataclasses.astuple(s) for s in inert.telemetry.samples] == \
        [dataclasses.astuple(s) for s in base.telemetry.samples]
    assert inert.engine.preemptions == base.engine.preemptions


def _fleet_migration(F, L, min_advantage):
    mig = L.QueueImbalanceMigration(min_advantage=min_advantage,
                                    max_moves_per_window=8)
    sr = F.run_fleet("fleet-fault-migration", 90, seed=1, router="jsq",
                     allocator="pack", rescan_interval=300.0, migration=mig)
    return (sorted(_job_tuple(j) for j in sr.result.jobs),
            _events(sr.fed.migrations), sorted(sr.fed.routes.items()),
            [(t.migrations_in, t.migrations_out) for t in sr.telemetries])


def test_fleet_migration_identical():
    """``fleet-fault-migration`` with ``QueueImbalanceMigration``: the
    same moves, routes and jobs as the reference, and moves did happen."""
    want = _fleet_migration(JF, JL, 2)
    got = _fleet_migration(TF, TL, 2)
    assert got == want
    jobs, moves, _, tel = got
    assert len(jobs) == 90 and moves
    assert sum(i for i, _ in tel) == sum(o for _, o in tel) == len(moves)


def test_migration_off_fleet_bit_identical():
    def sig(migration):
        sr = TF.run_fleet("fleet-fault-storm", 48, seed=5, router="jsq",
                          allocator="pack", rescan_interval=300.0,
                          migration=migration)
        return sorted(_job_tuple(j) for j in sr.result.jobs), sr.fed.migrations
    base = sig(None)
    inert = sig(TL.QueueImbalanceMigration(min_advantage=10 ** 9))
    assert inert == base and not inert[1]


def test_failover_roundtrip_after_controller_acts():
    """``save_state`` / ``load_state`` after the full controller has
    preempted, deadline-started and resized jobs: the restored engine,
    driven on by the same controller, finishes as the uninterrupted one."""
    def run(cut: bool):
        run = TS.get_scenario("slo-lanes").build(120, 0)
        eng = TS.SchedulerEngine(run.spec,
                                 PolicyPrioritizer(make_policy("fcfs")),
                                 allocator="pack")
        eng.submit([j.clone_pending() for j in run.jobs])
        ctl = CONTROLLERS["slo+elastic"](TL)
        t, iv = run.jobs[0].submit_time, 60.0
        while not eng.done:
            eng.step(t + iv)
            t += iv
            ctl.control(eng, t)
            if cut and len(ctl.events) >= 10:
                eng = TS.SchedulerEngine.load_state(eng.save_state())
                cut = False
            if eng.next_event_time() == math.inf and not eng.done:
                break
        assert not cut                     # the restore did happen
        return (sorted(_job_tuple(j) for j in eng.completed),
                _events(ctl.events), eng.preemptions)

    straight = run(False)
    assert run(True) == straight
    assert straight[2] > 0 and len(straight[0]) == 120

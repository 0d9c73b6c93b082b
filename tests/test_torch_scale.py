"""The port's autoscalers and parallel federation stepping against the JAX
package's (the analogs of ``tests/test_autoscaling.py`` and
``tests/test_scale.py``).

The controllers are host numpy over the cluster's elastic entry points, so
their scale events and the schedules they shape must equal the
reference's exactly.  Their demand forecast runs the runtime predictor's
forward (the plain torch version here), which agrees with the reference's
within 1e-5 per residual; the forecast is held within a relative 1e-5 and
the decision it gates exactly.  A controller that can never act is
unobservable, and ``parallel=True`` replays every fleet scenario as the
serial loop does, which is the reference's schedule.
"""
import dataclasses

import pytest
import torch

import repro.core as J
import repro.fed as JF
import repro.scale as JSC
import repro.sched as JS
import repro_torch.core as T
import repro_torch.fed as TF
import repro_torch.scale as TSC
import repro_torch.sched as TS
from repro.predict import RuntimePredictor as JRuntimePredictor
from repro_torch.predict import RuntimePredictor
from test_torch_stream import _job_tuple, _signature

torch.set_num_threads(1)

SCENARIOS = sorted(JS.list_scenarios())
FLEETS = sorted(JF.FLEET_SCENARIOS)

#: the controller configurations of ``benchmarks/bench_autoscaling.py``
CONTROLLERS = {
    "target-util": lambda SC, spec: SC.TargetUtilizationAutoscaler(
        SC.pools_from_spec(spec, min_frac=0.25), util_low=0.6,
        util_high=0.85, max_pending_for_down=4, cooldown_s=1800.0),
    "queue-pressure": lambda SC, spec: SC.QueuePressureAutoscaler(
        SC.pools_from_spec(spec, min_frac=0.25), wait_up_s=1800.0,
        wait_down_s=300.0, util_down=0.55, cooldown_s=1800.0),
}


def _events(events) -> list[tuple]:
    return [dataclasses.astuple(e) for e in events]


def test_registry_and_pools_identical():
    assert TSC.list_autoscalers() == JSC.list_autoscalers()
    assert sorted(TSC.__all__) == sorted(JSC.__all__)
    for name in ("helios", "philly", "slurm-testbed"):
        for kw in ({}, {"min_frac": 0.25}, {"max_frac": 2.0}):
            want = JSC.pools_from_spec(J.make_cluster(name), **kw)
            got = TSC.pools_from_spec(T.make_cluster(name), **kw)
            assert {k: dataclasses.astuple(v) for k, v in got.items()} == \
                {k: dataclasses.astuple(v) for k, v in want.items()}
    for name in JSC.list_autoscalers():
        want = JSC.make_autoscaler(name, J.make_cluster("helios"),
                                   min_frac=0.5, cooldown_s=900.0)
        got = TSC.make_autoscaler(name, T.make_cluster("helios"),
                                  min_frac=0.5, cooldown_s=900.0)
        assert type(got).__name__ == type(want).__name__
        assert {k: dataclasses.astuple(v) for k, v in got.pools.items()} == \
            {k: dataclasses.astuple(v) for k, v in want.pools.items()}
        assert got.cooldown_s == want.cooldown_s == 900.0


@pytest.mark.parametrize("scenario", ["diurnal", "flash-crowd"])
@pytest.mark.parametrize("controller", sorted(CONTROLLERS))
def test_autoscaled_stream_identical(scenario, controller):
    """Both controllers at the autoscaling bench's settings (``pack``,
    rescan 60 s, hourly samples): the same scale events, schedule,
    telemetry and GPU-hours as the reference, with the controller acting."""
    out = []
    for S, SC in ((JS, JSC), (TS, TSC)):
        run = S.get_scenario(scenario).build(300, 0)
        asc = CONTROLLERS[controller](SC, run.spec)
        sr = S.run_scenario(run, allocator="pack", rescan_interval=60.0,
                            sample_interval=3600.0, autoscaler=asc)
        tel = sr.telemetry
        out.append((_events(asc.events), _signature(sr.engine),
                    sorted(_job_tuple(j) for j in sr.batch.jobs),
                    [dataclasses.astuple(s) for s in tel.samples],
                    tel.provisioned_gpu_hours, tel.used_gpu_hours,
                    sr.windows))
    assert out[1] == out[0]
    assert out[1][0], "the controller never acted"


def _frozen(SC, spec):
    """A controller whose band spans [0, 1]: it can never act."""
    return SC.TargetUtilizationAutoscaler(SC.pools_from_spec(spec),
                                          util_low=0.0, util_high=1.0)


@pytest.mark.parametrize("name", SCENARIOS)
def test_disabled_autoscaler_bit_identical(name):
    base = TS.run_scenario(TS.get_scenario(name).build(64, seed=5),
                           allocator="pack", rescan_interval=300.0)
    run = TS.get_scenario(name).build(64, seed=5)
    frozen = TS.run_scenario(run, allocator="pack", rescan_interval=300.0,
                             autoscaler=_frozen(TSC, run.spec))
    assert _signature(frozen.engine) == _signature(base.engine)
    assert [dataclasses.astuple(s) for s in frozen.telemetry.samples] == \
        [dataclasses.astuple(s) for s in base.telemetry.samples]


def _mk(pkg, i, gpus, runtime, submit):
    return pkg.Job(job_id=i, user=0, submit_time=submit, runtime=runtime,
                   est_runtime=runtime, num_gpus=gpus)


def _forecast_case(pkg, S, SC, pred, kind):
    """``tests/test_predict.py``'s forecast cases: a saturated cluster with
    a predicted backlog (queue pressure scales up), or an idle one with a
    fat backlog (target utilisation holds its scale-down)."""
    spec = pkg.make_cluster("helios")
    pri = pkg.PolicyPrioritizer(pkg.make_policy("fcfs", use_estimates=True))
    eng = S.SchedulerEngine(spec, pri, allocator="pack", hooks=(pred,),
                            predictor=pred)
    if kind == "up":
        asc = SC.QueuePressureAutoscaler(SC.pools_from_spec(spec,
                                                            max_frac=2.0),
                                         forecast_up_gpu_hours=4.0)
        eng.submit([_mk(pkg, 1, 80, 40000.0, 0.0)]
                   + [_mk(pkg, 10 + i, 8, 7200.0, 1.0) for i in range(6)])
        now = 2.0
    else:
        asc = SC.TargetUtilizationAutoscaler(SC.pools_from_spec(spec),
                                             max_pending_for_down=64,
                                             forecast_hold_gpu_hours=2.0)
        eng.submit([_mk(pkg, 10 + i, 100, 7200.0, 0.0) for i in range(4)])
        now = 1.0
    eng.step(now)
    return asc._forecast_gpu_hours(eng), asc.desired_direction(eng, now, None)


@pytest.mark.parametrize("kind", ["up", "hold"])
def test_forecast_with_port_predictor(kind):
    """The autoscaler's demand forecast through the port's predictor
    (``pending_gpu_hours`` -> ``predict_mlp``) within 1e-5 of the
    reference's, and the direction it gates equal."""
    want = _forecast_case(J, JS, JSC, JRuntimePredictor(assist=True), kind)
    got = _forecast_case(T, TS, TSC,
                         RuntimePredictor(assist=True, device="cpu"), kind)
    assert got[0] == pytest.approx(want[0], rel=1e-5, abs=0)
    assert got[1] == want[1]
    assert got[1][0] == (1 if kind == "up" else 0)
    shadow = _forecast_case(T, TS, TSC,
                            RuntimePredictor(assist=False, device="cpu"),
                            kind)
    assert shadow[0] is None


def _fleet_sig(sr):
    """``tests/test_scale.py``'s bit-identity signature (every job field
    here), with the autoscalers' and migrations' events."""
    eng = sr.fed.engines
    return (sorted(_job_tuple(j) for j in sr.result.jobs),
            tuple(e.decisions for e in eng), tuple(e.backfills for e in eng),
            tuple(e.milp_calls for e in eng), tuple(sr.fed.routed),
            sr.fed.deferrals, _events(sr.fed.migrations), sr.windows)


@pytest.mark.parametrize("name", FLEETS)
def test_parallel_federation_identical(name):
    """``parallel=True`` on every registered fleet scenario (fault storms
    and blackout chaos included) equals the port's serial loop, which
    equals the reference's serial run."""
    want = _fleet_sig(JF.run_fleet(name, num_jobs=120, seed=3,
                                   allocator="pack"))
    serial = _fleet_sig(TF.run_fleet(name, num_jobs=120, seed=3,
                                     allocator="pack"))
    par = _fleet_sig(TF.run_fleet(name, num_jobs=120, seed=3,
                                  allocator="pack", parallel=True))
    assert serial == want
    assert par == serial


def test_autoscaled_parallel_fleet_with_predictors_identical():
    """The chip run's fleet in small: ``fleet-skewed-flash`` with an
    assisted predictor and a target-utilisation controller in every
    member, stepped in parallel, equals the reference's serial run."""
    out = []
    for F, SC, P, kw in ((JF, JSC, JRuntimePredictor, {}),
                         (TF, TSC, RuntimePredictor, {"device": "cpu"})):
        autoscalers = []

        def autoscaler(i, spec):
            autoscalers.append(CONTROLLERS["target-util"](SC, spec))
            return autoscalers[-1]
        sr = F.run_fleet("fleet-skewed-flash", num_jobs=300, seed=0,
                         router="jsq", allocator="pack", rescan_interval=60.0,
                         parallel=F is TF, autoscaler_factory=autoscaler,
                         predictor_factory=lambda i, spec: P(
                             assist=True, seed=i, **kw))
        out.append((_fleet_sig(sr), [_events(a.events) for a in autoscalers],
                    tuple((e.bf_reservations, e.bf_overruns)
                          for e in sr.fed.engines)))
    assert out[1] == out[0]
    assert any(out[1][1]) and sum(r for r, _ in out[1][2]) > 0


def test_parallel_federation_pool_lifecycle():
    run = TF.FLEET_SCENARIOS["fleet-steady"].build(60, 1)
    fed = TF.FederatedScheduler(run.clusters, "jsq",
                                fault_models=run.fault_models, parallel=True)
    assert fed._pool is None
    fed.submit(run.jobs)
    fed.step(run.jobs[0].submit_time + 3600.0)
    assert fed._pool is not None
    fed.close()
    assert fed._pool is None
    fed.close()
    fed.run_until_complete()
    assert fed.done
    fed.close()

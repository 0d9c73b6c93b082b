"""The port's streaming service against the JAX package's.

``run_scenario`` replays each registered scenario through the engine with
rolling telemetry, the SLA lane and quota wrappers, and (``chaos-storm``)
the correlated-chaos injector.  All of it is host numpy, so the schedule
signature (``tests/test_predict.py``'s) and every telemetry sample must
equal the reference's exactly.  A shadow predictor (``assist=False``) must
leave the schedule bit-identical to ``predictor=None``; an assisted one
steers backfill through the predictor's forward (the plain torch version
here) and must give the reference's signature, which holds while no p90
gate ``now + p90 <= t_res`` falls within the forward's f32 error of a tie.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as J
import repro.lifecycle.costs as j_costs
import repro.sched as JS
import repro_torch.core as T
import repro_torch.lifecycle as t_lifecycle
import repro_torch.sched as TS
from repro.predict import RuntimePredictor as JRuntimePredictor
from repro_torch.predict import RuntimePredictor

SCENARIOS = sorted(JS.list_scenarios())


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


def _job_tuple(job) -> tuple:
    """Every field of a Job, with the state enum by name (the two packages
    have distinct enum classes)."""
    return tuple(getattr(job, f.name).name if f.name == "state"
                 else getattr(job, f.name) for f in dataclasses.fields(job))


def _samples(sr):
    return [dataclasses.astuple(s) for s in sr.telemetry.samples]


def test_registry_identical():
    assert sorted(TS.list_scenarios()) == SCENARIOS
    for name in ("mispredict-storm", "padded-estimates", "overcommit-queue",
                 "flash-crowd", "chaos-storm"):
        assert name in SCENARIOS
        got = TS.get_scenario(name).description   # names its own package
        assert got.replace("repro_torch.", "repro.") == \
            JS.get_scenario(name).description


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_build_identical(scenario):
    want = JS.get_scenario(scenario).build(120, 2)
    got = TS.get_scenario(scenario).build(120, 2)
    assert got.name == want.name
    assert dataclasses.astuple(got.spec) == dataclasses.astuple(want.spec)
    assert [_job_tuple(j) for j in got.jobs] == \
        [_job_tuple(j) for j in want.jobs]
    assert (got.sla_users, got.vc_quotas) == (want.sla_users, want.vc_quotas)
    assert (got.fault_model is None) == (want.fault_model is None)
    if want.fault_model is not None:
        assert dataclasses.astuple(got.fault_model) == \
            dataclasses.astuple(want.fault_model)
    assert (got.chaos is None) == (want.chaos is None)
    if want.chaos is not None:
        assert [dataclasses.astuple(e) for e in got.chaos.events] == \
            [dataclasses.astuple(e) for e in want.chaos.events]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_run_scenario_identical(scenario):
    """Default service settings (MILP placement, backfill, FCFS): the same
    signature, windows and telemetry samples as the reference."""
    want = JS.run_scenario(scenario, num_jobs=90, seed=1)
    got = TS.run_scenario(scenario, num_jobs=90, seed=1)
    assert _signature(got.engine) == _signature(want.engine)
    assert got.windows == want.windows
    assert _samples(got) == _samples(want)
    assert len(got.batch.jobs) == 90
    if scenario == "chaos-storm":            # the injector really fired
        assert max(s.nodes_down for s in got.telemetry.samples) > 0


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_shadow_predictor_is_bit_identical_per_scenario(scenario):
    """assist=False trains from the hook stream but never steers: job tuples
    and every decision/backfill counter match predictor=None."""
    base = TS.run_scenario(scenario, num_jobs=90, seed=1)
    shadow = RuntimePredictor(assist=False, seed=0, device="cpu")
    got = TS.run_scenario(scenario, num_jobs=90, seed=1, predictor=shadow)
    assert _signature(got.engine) == _signature(base.engine)
    assert got.engine.bf_reservations == 0
    assert got.engine.bf_overruns == 0
    assert shadow.train_steps == len(got.batch.jobs)


def _est_pri(pkg):
    return pkg.PolicyPrioritizer(pkg.make_policy("fcfs", use_estimates=True))


@pytest.mark.parametrize("scenario,num_jobs,seed",
                         [("flash-crowd", 200, 1), ("mispredict-storm", 300, 0)])
def test_assisted_stream_identical(scenario, num_jobs, seed):
    """Predictor-assisted EASY backfill at the prediction bench's settings
    (``pack``, rescan 60 s, FCFS on estimates): the port's signature,
    telemetry and trained predictor equal the reference's."""
    out = []
    for S, pkg, pred in ((JS, J, JRuntimePredictor(assist=True, seed=0)),
                         (TS, T, RuntimePredictor(assist=True, seed=0,
                                                  device="cpu"))):
        sr = S.run_scenario(scenario, num_jobs=num_jobs, seed=seed,
                            allocator="pack", rescan_interval=60.0,
                            sample_interval=3600.0, prioritizer=_est_pri(pkg),
                            predictor=pred)
        out.append((sr, pred))
    (jsr, jp), (tsr, tp) = out
    assert tsr.engine.bf_reservations > 0
    assert _signature(tsr.engine) == _signature(jsr.engine)
    assert _samples(tsr) == _samples(jsr)
    assert (tp.train_steps, tp.mape(), tp.baseline_mape()) == \
        (jp.train_steps, jp.mape(), jp.baseline_mape())
    # slack = t_res - (now + p90): p90 (up to ~1e4 s) agrees within ~1e-6
    # relative, so the slacks agree within ~0.01 s
    assert list(tp.reservation_slacks) == pytest.approx(
        list(jp.reservation_slacks), rel=0, abs=1e-2)


@pytest.mark.parametrize("quotas", [False, True])
def test_run_stream_tenancy_wrappers_identical(quotas):
    """run_stream directly, with the SLA lane and (optionally) the quota
    gate wrapped around the prioritizer by ``wrap_tenancy``."""
    out = []
    for S, pkg in ((JS, J), (TS, T)):
        run = S.get_scenario("multi-tenant" if quotas else "sla-mix").build(
            150, 3)
        pri = S.wrap_tenancy(pkg.PolicyPrioritizer(pkg.make_policy("sjf")),
                             run.sla_users, run.vc_quotas)
        telemetry = S.RollingTelemetry(window=3600.0, sample_interval=900.0)
        sr = S.run_stream(run.spec, [j.clone_pending() for j in run.jobs],
                          pri, allocator="pack", telemetry=telemetry,
                          chunked_submit=True)
        out.append((_signature(sr.engine), _samples(sr), sr.windows,
                    type(pri).__name__))
    assert out[0] == out[1]
    assert out[1][3] == ("QuotaPrioritizer" if quotas else "SlaLanePrioritizer")


def test_telemetry_helpers_identical():
    shares = list(np.random.default_rng(0).uniform(0, 5, 7)) + [0.0]
    assert TS.jain_index(shares) == JS.jain_index(shares)
    assert TS.jain_index([]) == JS.jain_index([]) == 1.0
    job = T.generate_trace("helios", 3, seed=0)[2]
    want = j_costs.CkptCostModel()
    got = t_lifecycle.CkptCostModel()
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.resume_penalty(job) == want.resume_penalty(
        J.generate_trace("helios", 3, seed=0)[2])

"""The port's federation (routers, fleet scenarios, ``FederatedScheduler``,
``run_fleet``) against the JAX package's (the analog of
``tests/test_federation.py``).

Routing and the lockstep windows are host numpy, so on the same views
every router picks the reference's member, every fleet scenario builds the
reference's clusters and jobs, and every fleet run gives the reference's
schedule job for job.  Members may carry runtime predictors (one each,
never shared): a shadow predictor leaves the fleet as without one, and an
assisted one (the plain torch forward here) gives the reference's fleet
while no p90 gate falls within the forward's f32 error of a tie.  A member
may rank with the greedy RL actor; with unit-scale weights carried across
by ``repro_torch.convert`` its logits are well separated (ROADMAP Queue 3
item 1), so the fleet equals the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as J
import repro.fed as JF
import repro.sched as JS
import repro_torch.core as T
import repro_torch.fed as TF
import repro_torch.sched as TS
from repro.kernels.batch_score import BucketedScorer as JBucketedScorer
from repro.predict import RuntimePredictor as JRuntimePredictor
from repro.sched.engine import EngineSnapshot as JEngineSnapshot
from repro_torch import convert
from repro_torch.kernels.batch_score import BucketedScorer
from repro_torch.predict import RuntimePredictor
from repro_torch.sched.engine import EngineSnapshot
from test_torch_slice import _unit_actor
from test_torch_stream import _job_tuple

torch.set_num_threads(1)

FLEETS = sorted(JF.list_fleet_scenarios())
ROUTERS = sorted(JF.list_routers())
SKUS = ("V100", "P100", "A100", "T4")


def test_registries_identical():
    assert sorted(TF.list_fleet_scenarios()) == FLEETS
    assert sorted(TF.list_routers()) == ROUTERS
    assert sorted(TF.__all__) == sorted(JF.__all__)


def _views(F, Snapshot, seed: int) -> list:
    """Six random fleet members: SKU mixes, totals, free GPUs and queue
    loads drawn from ``seed`` (one member fully failed: zero free)."""
    rng = np.random.default_rng(seed)
    views = []
    for i in range(6):
        skus = sorted(rng.choice(SKUS, size=int(rng.integers(1, 4)),
                                 replace=False))
        by_type = {str(s): int(rng.integers(1, 9)) * 8 for s in skus}
        total = sum(by_type.values())
        free_by_type = {s: 0 if i == 5 else int(rng.integers(0, n + 1))
                        for s, n in by_type.items()}
        submitted = int(rng.integers(0, 200))
        completed = int(rng.integers(0, submitted + 1))
        info = F.ClusterInfo(index=i, name=f"c{i}", total_gpus=total,
                             total_by_type=by_type)
        snap = Snapshot(
            now=0.0, submitted=submitted,
            num_pending=int(rng.integers(0, submitted - completed + 1)),
            num_running=0, num_completed=completed,
            free_gpus=sum(free_by_type.values()), utilization=0.5,
            fragmentation=0.0, decisions=0, milp_calls=0, backfills=0,
            restarts=0, free_gpus_by_type=free_by_type)
        views.append(F.ClusterView(info, snap))
    return views


def _jobs(pkg, seed: int, n: int = 300) -> list:
    rng = np.random.default_rng(seed)
    types = ("any",) + SKUS + ("H100",)
    return [pkg.Job(job_id=i, user=int(rng.integers(0, 20)),
                    submit_time=float(i), runtime=100.0, est_runtime=100.0,
                    num_gpus=int(rng.choice([1, 2, 4, 8, 16, 32, 128])),
                    gpu_type=str(rng.choice(types)))
            for i in range(n)]


@pytest.mark.parametrize("router", ROUTERS)
def test_router_choices_identical(router):
    """On the same views, every job goes where the reference sends it;
    capable-cluster filtering (and its degradation) agrees as well."""
    for seed in range(3):
        jv, tv = _views(JF, JEngineSnapshot, seed), _views(TF, EngineSnapshot,
                                                           seed)
        jr, tr = JF.make_router(router, seed=1), TF.make_router(router, seed=1)
        want = [jr.route(j, jv) for j in _jobs(J, seed)]
        got = [tr.route(j, tv) for j in _jobs(T, seed)]
        assert got == want
        assert len(set(got)) > 1
        assert [TF.capable_clusters(j, tv) for j in _jobs(T, seed)] == \
            [JF.capable_clusters(j, jv) for j in _jobs(J, seed)]


@pytest.mark.parametrize("name", FLEETS)
def test_fleet_scenario_build_identical(name):
    want = JF.get_fleet_scenario(name).build(150, 3)
    got = TF.get_fleet_scenario(name).build(150, 3)
    assert got.name == want.name
    assert [dataclasses.astuple(c) for c in got.clusters] == \
        [dataclasses.astuple(c) for c in want.clusters]
    assert [_job_tuple(j) for j in got.jobs] == \
        [_job_tuple(j) for j in want.jobs]
    assert (got.sla_users, got.vc_quotas) == (want.sla_users, want.vc_quotas)
    assert [None if f is None else dataclasses.astuple(f)
            for f in got.fault_models] == \
        [None if f is None else dataclasses.astuple(f)
         for f in want.fault_models]
    assert (got.chaos is None) == (want.chaos is None)
    if want.chaos is not None:
        assert [dataclasses.astuple(e) for e in got.chaos.events] == \
            [dataclasses.astuple(e) for e in want.chaos.events]


def _fleet_out(sr) -> tuple:
    """Every completed job's fields, per member counters, routing, the
    fleet result's aggregates and the final snapshot."""
    res = sr.result
    agg = tuple(getattr(res, f.name) for f in dataclasses.fields(res)
                if f.name not in ("per_cluster", "jobs"))
    per = [(b.makespan, b.total_wait, b.gpu_seconds_used, b.decisions,
            b.milp_calls, b.backfills, b.restarts) for b in res.per_cluster]
    snap = sr.snapshot
    return (sorted(_job_tuple(j) for j in res.jobs),
            tuple((e.decisions, e.milp_calls, e.backfills, e.restarts,
                   e.bf_reservations, e.bf_overruns) for e in sr.fed.engines),
            sorted(sr.fed.routes.items()), sr.fed.deferrals, sr.windows,
            agg, per, (snap.submitted, snap.num_completed, snap.utilization,
                       snap.fairness, tuple(snap.routed)),
            [dataclasses.astuple(a) for a in sr.fed.chaos_actions])


def _fleet_pair(name, router, num_jobs=120, **kw):
    want = _fleet_out(JF.run_fleet(name, num_jobs=num_jobs, seed=3,
                                   router=router, allocator="pack", **kw))
    got = _fleet_out(TF.run_fleet(name, num_jobs=num_jobs, seed=3,
                                  router=router, allocator="pack", **kw))
    return got, want


@pytest.mark.parametrize("router", ["hash", "sku-affinity"])
@pytest.mark.parametrize("name", FLEETS)
def test_fleet_identical(name, router):
    """Every fleet scenario under two routers (``jsq``, the default, runs
    in ``test_torch_scale.py``): the reference's fleet, job for job."""
    got, want = _fleet_pair(name, router)
    assert got == want
    assert len(got[0]) == 120


@pytest.mark.parametrize("router", ["free-gpus", "weighted-random"])
def test_fleet_identical_other_routers(router):
    got, want = _fleet_pair("fleet-skewed-flash", router, num_jobs=150,
                            parallel=True)
    assert got == want


def test_fleet_snapshot_mid_run_identical():
    out = []
    for F in (JF, TF):
        run = F.get_fleet_scenario("fleet-steady").build(36, seed=1)
        fed = F.FederatedScheduler(run.clusters, "jsq", allocator="pack",
                                   fault_models=run.fault_models)
        fed.submit([j.clone_pending() for j in run.jobs])
        fed.step(fed.next_event_time() + 3600.0)
        snap = fed.snapshot()
        out.append((dataclasses.astuple(snap), sorted(fed.routes.items())))
        fed.drain()
    assert out[1] == out[0]


def _sig(sr):
    """``tests/test_predict.py``'s fleet signature."""
    jobs = tuple(sorted(
        (j.job_id, round(j.submit_time, 6),
         round(j.first_start_time if j.first_start_time is not None else -1,
               6),
         round(j.finish_time if j.finish_time is not None else -1, 6),
         j.restarts) for j in sr.result.jobs))
    return jobs, tuple((e.decisions, e.milp_calls, e.backfills,
                        e.bf_reservations, e.bf_overruns)
                       for e in sr.fed.engines)


def test_shadow_predictor_fleet_bit_identical():
    base = _sig(TF.run_fleet("fleet-skewed-flash", num_jobs=120, seed=3))
    preds = []

    def factory(i, spec):
        preds.append(RuntimePredictor(assist=False, seed=i, device="cpu"))
        return preds[-1]
    got = TF.run_fleet("fleet-skewed-flash", num_jobs=120, seed=3,
                       predictor_factory=factory)
    assert _sig(got) == base
    assert len({id(p) for p in preds}) == len(preds) == 3   # one each
    assert sum(p.train_steps for p in preds) == 120


def test_assisted_predictor_fleet_identical():
    """An assisted predictor in every member, MILP placement with the
    predictor's look-ahead durations: the reference's fleet signature, the
    same trained predictors, and reservations were committed."""
    out = []
    for F, P, kw in ((JF, JRuntimePredictor, {}),
                     (TF, RuntimePredictor, {"device": "cpu"})):
        preds = []

        def factory(i, spec):
            preds.append(P(assist=True, seed=i, **kw))
            return preds[-1]
        sr = F.run_fleet("fleet-skewed-flash", num_jobs=150, seed=3,
                         rescan_interval=60.0, predictor_factory=factory)
        out.append((_sig(sr), [(p.train_steps, p.mape(), p.baseline_mape())
                               for p in preds]))
    assert out[1] == out[0]
    assert sum(e[3] for e in out[1][0][1]) > 0


def _rl_member_fleet(F, S, pkg, agent, scorer_cls):
    """Member 0 ranks with the greedy actor (deep scorer on), the others
    with FCFS; all wrapped in the fleet's tenancy lanes."""
    run = F.get_fleet_scenario("fleet-skewed-flash").build(200, 0)

    def factory(i):
        base = pkg.RLPrioritizer(agent, explore=False,
                                 deep_scorer=scorer_cls(
                                     agent.params["actor"])) \
            if i == 0 else pkg.PolicyPrioritizer(pkg.make_policy("fcfs"))
        return S.wrap_tenancy(base, run.sla_users, run.vc_quotas)
    return F.run_fleet(run, router="jsq", allocator="pack",
                       rescan_interval=60.0, prioritizer_factory=factory,
                       parallel=F is TF)


def test_greedy_rl_member_fleet_identical():
    ja = J.PPOAgent()
    state = ja.state_dict()
    state["params"]["actor"] = _unit_actor(3)
    ja.load_state_dict(state)
    ta = T.PPOAgent(device="cpu")
    convert.load_numpy_params(ta.net, ja.state_dict()["params"])
    want = _rl_member_fleet(JF, JS, J, ja, JBucketedScorer)
    got = _rl_member_fleet(TF, TS, T, ta, BucketedScorer)
    assert _sig(got) == _sig(want)
    assert _sig(got) != _sig(TF.run_fleet(
        "fleet-skewed-flash", num_jobs=200, seed=0, router="jsq",
        allocator="pack", rescan_interval=60.0))   # the actor did steer
    assert got.fed.engines[0].decisions > 0


def test_federation_validates_inputs():
    spec = T.make_cluster("helios")
    with pytest.raises(ValueError, match="at least one cluster"):
        TF.FederatedScheduler([], "jsq")
    with pytest.raises(ValueError, match="fault models"):
        TF.FederatedScheduler([spec], "jsq", fault_models=[None, None])
    with pytest.raises(ValueError, match="predictors"):
        TF.FederatedScheduler([spec], "jsq", predictors=[None, None])
    with pytest.raises(KeyError, match="unknown fleet scenario"):
        TF.get_fleet_scenario("no-such-fleet")
    with pytest.raises(KeyError, match="unknown router"):
        TF.make_router("no-such-router")

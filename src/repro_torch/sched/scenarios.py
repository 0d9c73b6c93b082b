"""Named stress scenarios for the streaming scheduler (Fig. 6 congestion).

Each scenario composes the statistically-matched trace generators in
``repro_torch.core.trace`` with a workload shaper (arrival-time warps, demand
skews, tenant mixes) and optionally a fault model, producing a
``ScenarioRun`` that the service driver replays through the engine.
Scenarios are deterministic in ``seed``.

Registry: ``SCENARIOS`` maps name -> ``Scenario``; use
``get_scenario(name)`` / ``list_scenarios()``.  Registered scenarios:

- ``steady``       — baseline Helios traffic (control).
- ``diurnal``      — day/night sinusoidal arrival intensity (inverse
                     rate-integral time warp of the base arrivals).
- ``flash-crowd``  — calm traffic with a dense conference-deadline spike.
- ``multi-tenant`` — 4 virtual clusters with skewed demand vs. quota
                     (fairness stress; telemetry tracks Jain's index).
- ``sla-mix``      — an SLA-bound user population mixed into best-effort
                     traffic (exercises the Sec. 3.1.2 SLA bypass lane).
- ``fault-storm``  — aggressive MTBF + stragglers (checkpoint/restart churn).
- ``sku-skew``     — demand concentrated on the scarce fast SKU of a
                     heterogeneous cluster (placement-quality stress).
- ``trace-replay`` — real arrival/duration/GPU-demand rows from a CSV
                     (normalized ``repro_torch.core.trace`` schema) replayed
                     through the engine; ``REPRO_TRACE_CSV`` points at an
                     external trace, defaulting to a packaged fixture.
- ``slo-lanes``    — deadline storm: congestion spike plus a deadline-
                     carrying job population and elastic gangs (the
                     ``repro_torch.lifecycle`` preemption-policy stress).
- ``chaos-storm``  — correlated chaos (``repro_torch.chaos``): rack bursts, spot-
                     reclamation waves and a straggler storm layered over
                     mild organic faults and a deadline-carrying population.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable

import numpy as np

from repro_torch.core.faults import FaultModel
from repro_torch.core.trace import generate_trace, load_trace_csv, make_cluster
from repro_torch.core.types import ClusterSpec, Job


@dataclasses.dataclass(frozen=True)
class ScenarioRun:
    """A concrete, replayable workload: cluster + job stream + faults."""

    name: str
    spec: ClusterSpec
    jobs: list[Job]
    fault_model: FaultModel | None = None
    sla_users: frozenset[int] = frozenset()
    vc_quotas: dict[int, float] | None = None   # VC id -> cluster share
    #: optional correlated-chaos timeline (a ``repro_torch.chaos.ChaosSchedule``,
    #: duck-typed to keep this module chaos-agnostic); the service driver
    #: wraps it in a fresh injector per run
    chaos: object | None = None


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named scenario: deterministic builder of ScenarioRuns."""

    name: str
    description: str
    build: Callable[[int, int], ScenarioRun]    # (num_jobs, seed) -> run


SCENARIOS: dict[str, Scenario] = {}


def register(name: str, description: str):
    def deco(fn: Callable[[int, int], ScenarioRun]):
        SCENARIOS[name] = Scenario(name=name, description=description, build=fn)
        return fn
    return deco


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {', '.join(sorted(SCENARIOS))}")
    return SCENARIOS[name]


def list_scenarios() -> list[str]:
    return sorted(SCENARIOS)


# ---------------------------------------------------------------- shapers ----


def _warp_arrivals(jobs: list[Job], rate: Callable[[float], float],
                   step: float = 600.0) -> None:
    """Re-time arrivals so instantaneous intensity follows ``rate(t)``
    (mean ~1.0, strictly positive) while preserving the base process's
    randomness: each original arrival time t maps to the s solving
    ``integral_0^s rate = t``.  The cumulative integral is tabulated on a
    coarse grid (rate varies slowly vs. ``step``) and inverted with a single
    monotone interpolation — O(grid + n) for the whole stream."""
    if not jobs:
        return
    target_max = max(j.submit_time for j in jobs)
    ts = [0.0]
    cum = [0.0]
    while cum[-1] < target_max:
        t0, t1 = ts[-1], ts[-1] + step
        cum.append(cum[-1] + 0.5 * (rate(t0) + rate(t1)) * step)
        ts.append(t1)
        assert len(ts) < 10_000_000, "rate(t) too close to zero to invert"
    targets = np.array([j.submit_time for j in jobs])
    warped = np.interp(targets, np.array(cum), np.array(ts))
    for j, s in zip(jobs, warped):
        j.submit_time = float(s)
    jobs.sort(key=lambda j: j.submit_time)


# --------------------------------------------------------------- scenarios ----


@register("steady", "Baseline Helios traffic, no shaping (control).")
def _steady(num_jobs: int, seed: int) -> ScenarioRun:
    return ScenarioRun(name="steady", spec=make_cluster("helios"),
                       jobs=generate_trace("helios", num_jobs, seed=seed))


@register("diurnal",
          "Day/night sinusoidal arrival intensity: 3x daytime peak vs "
          "nighttime trough over a 24h period.")
def _diurnal(num_jobs: int, seed: int) -> ScenarioRun:
    jobs = generate_trace("helios", num_jobs, seed=seed)

    def rate(t: float) -> float:
        # mean 1.0; peak 1.75, trough 0.25 (roughly 7:1 day/night swing)
        return 1.0 + 0.75 * math.sin(2 * math.pi * t / 86400.0)

    _warp_arrivals(jobs, rate)
    return ScenarioRun(name="diurnal", spec=make_cluster("helios"), jobs=jobs)


@register("flash-crowd",
          "Calm traffic with a dense spike: 30% of jobs re-arrive inside a "
          "10-minute window (conference-deadline crowd).")
def _flash_crowd(num_jobs: int, seed: int) -> ScenarioRun:
    jobs = generate_trace("helios", num_jobs, seed=seed)
    rng = np.random.default_rng(seed + 101)
    if jobs:
        horizon = jobs[-1].submit_time
        t_spike = 0.5 * horizon
        crowd = rng.random(len(jobs)) < 0.30
        for j, hit in zip(jobs, crowd):
            if hit:
                j.submit_time = t_spike + float(rng.uniform(0.0, 600.0))
        jobs.sort(key=lambda j: j.submit_time)
    return ScenarioRun(name="flash-crowd", spec=make_cluster("helios"),
                       jobs=jobs)


@register("multi-tenant",
          "Four virtual clusters with skewed demand (55/25/12/8%) against "
          "even 25% quotas — fairness stress for per-VC telemetry.")
def _multi_tenant(num_jobs: int, seed: int) -> ScenarioRun:
    jobs = generate_trace("alibaba", num_jobs, seed=seed)
    rng = np.random.default_rng(seed + 202)
    shares = np.array([0.55, 0.25, 0.12, 0.08])
    vcs = rng.choice(4, size=len(jobs), p=shares)
    for j, vc in zip(jobs, vcs):
        j.vc = int(vc)
    return ScenarioRun(name="multi-tenant", spec=make_cluster("alibaba"),
                       jobs=jobs,
                       vc_quotas={0: 0.25, 1: 0.25, 2: 0.25, 3: 0.25})


@register("sla-mix",
          "10% of users are SLA-bound (Sec. 3.1.2 bypass lane) amid "
          "best-effort traffic.")
def _sla_mix(num_jobs: int, seed: int) -> ScenarioRun:
    jobs = generate_trace("helios", num_jobs, seed=seed)
    users = sorted({j.user for j in jobs})
    rng = np.random.default_rng(seed + 303)
    k = max(1, len(users) // 10)
    sla = frozenset(int(u) for u in rng.choice(users, size=k, replace=False))
    return ScenarioRun(name="sla-mix", spec=make_cluster("helios"), jobs=jobs,
                       sla_users=sla)


@register("fault-storm",
          "Aggressive failures: 6h per-node MTBF, 10-minute repairs, 30% "
          "straggler draws — checkpoint/restart and re-queue churn.")
def _fault_storm(num_jobs: int, seed: int) -> ScenarioRun:
    jobs = generate_trace("philly", num_jobs, seed=seed)
    fm = FaultModel(mtbf_per_node=6 * 3600.0, repair_time=600.0,
                    straggler_prob=0.3, straggler_slowdown=0.4,
                    ckpt_interval=900.0, seed=seed + 404)
    return ScenarioRun(name="fault-storm", spec=make_cluster("philly"),
                       jobs=jobs, fault_model=fm)


#: Environment override for the trace-replay scenario's CSV source.
TRACE_CSV_ENV = "REPRO_TRACE_CSV"
_DEFAULT_TRACE_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "data", "trace_small.csv")


def replay_trace_jobs(path: str, num_jobs: int) -> list[Job]:
    """Adapt a normalized-CSV trace (``repro_torch.core.trace.load_trace_csv``)
    into a ``num_jobs``-long stream: rows are truncated or tiled (each copy
    time-shifted by the trace span plus one mean inter-arrival gap, so
    copies never interleave) and re-id'd sequentially.  Deterministic — a
    replay has no seed."""
    base = load_trace_csv(path)
    if not base:
        raise ValueError(f"empty trace CSV: {path!r}")
    t0 = base[0].submit_time
    span = base[-1].submit_time - t0
    period = span + max(span / len(base), 1.0)
    jobs: list[Job] = []
    shift = 0.0
    while len(jobs) < num_jobs:
        for j in base:
            if len(jobs) >= num_jobs:
                break
            c = j.clone_pending()
            c.job_id = len(jobs)
            c.submit_time = j.submit_time + shift
            jobs.append(c)
        shift += period
    return jobs


@register("trace-replay",
          "Replay real arrival/duration/GPU-demand rows from a CSV "
          "(REPRO_TRACE_CSV, else a packaged fixture) through the engine.")
def _trace_replay(num_jobs: int, seed: int) -> ScenarioRun:
    path = os.environ.get(TRACE_CSV_ENV) or _DEFAULT_TRACE_CSV
    return ScenarioRun(name="trace-replay", spec=make_cluster("helios"),
                       jobs=replay_trace_jobs(path, num_jobs))


@register("slo-lanes",
          "Deadline storm under congestion: a 30-minute arrival spike, ~30% "
          "of jobs carrying hard deadlines (1.5-3x their estimate), and ~25% "
          "elastic gangs — the repro_torch.lifecycle preemption stress.")
def _slo_lanes(num_jobs: int, seed: int) -> ScenarioRun:
    jobs = generate_trace("helios", num_jobs, seed=seed)
    rng = np.random.default_rng(seed + 707)
    if jobs:
        # congestion: re-time a third of the stream into one dense spike so
        # deadline jobs genuinely contend for GPUs
        horizon = jobs[-1].submit_time
        t_spike = 0.5 * horizon
        crowd = rng.random(len(jobs)) < 0.35
        for j, hit in zip(jobs, crowd):
            if hit:
                j.submit_time = t_spike + float(rng.uniform(0.0, 1800.0))
        jobs.sort(key=lambda j: j.submit_time)
    dl = rng.random(len(jobs)) < 0.30
    factors = rng.uniform(1.5, 3.0, size=len(jobs))
    el = rng.random(len(jobs)) < 0.25
    for j, is_dl, f, is_el in zip(jobs, dl, factors, el):
        if is_dl:
            # deadline anchored on the *user-visible* estimate, like a real
            # SLO contract; floored so sub-10-minute jobs get usable slack
            j.deadline = j.submit_time + float(f) * max(j.est_runtime, 600.0)
        elif is_el and j.num_gpus >= 2:
            j.min_gpus = max(1, j.num_gpus // 2)
            j.max_gpus = j.num_gpus * 2
    return ScenarioRun(name="slo-lanes", spec=make_cluster("helios"),
                       jobs=jobs)


@register("chaos-storm",
          "Correlated chaos over Helios: two rack bursts, two P100 spot-"
          "reclamation waves, one straggler storm — layered on mild organic "
          "faults and a ~20% deadline population (repro_torch.chaos stress).")
def _chaos_storm(num_jobs: int, seed: int) -> ScenarioRun:
    from repro_torch.chaos import ChaosSchedule
    jobs = generate_trace("helios", num_jobs, seed=seed)
    rng = np.random.default_rng(seed + 910)
    dl = rng.random(len(jobs)) < 0.20
    factors = rng.uniform(2.0, 4.0, size=len(jobs))
    for j, is_dl, f in zip(jobs, dl, factors):
        if is_dl:
            j.deadline = j.submit_time + float(f) * max(j.est_runtime, 600.0)
    horizon = jobs[-1].submit_time if jobs else 86400.0
    # helios: nodes 0-4 are the P100 half, 5-9 the V100 half — each burst
    # takes most of one rack; reclamation sweeps the preemptible P100 pool
    chaos = (ChaosSchedule()
             .add_rack_burst(0.25 * horizon, nodes=range(0, 4),
                             down_for=2 * 3600.0, note="rack-P100")
             .add_spot_wave(0.45 * horizon, sku="P100", count=3,
                            down_for=2 * 3600.0)
             .add_spot_wave(0.55 * horizon, sku="P100", count=3,
                            down_for=2 * 3600.0)
             .add_straggler_storm(0.6 * horizon, nodes=range(4, 8),
                                  duration=3 * 3600.0, slowdown=0.4)
             .add_rack_burst(0.7 * horizon, nodes=range(5, 9),
                             down_for=3 * 3600.0, note="rack-V100"))
    fm = FaultModel(mtbf_per_node=14 * 86400.0, repair_time=1800.0,
                    straggler_prob=0.05, straggler_slowdown=0.5,
                    ckpt_interval=900.0, seed=seed + 909)
    return ScenarioRun(name="chaos-storm", spec=make_cluster("helios"),
                       jobs=jobs, fault_model=fm, chaos=chaos)


@register("padded-estimates",
          "Flash-crowd congestion where every user habitually pads their "
          "walltime request (est 2-8x true runtime, the documented "
          "production pattern) — blind backfill sees oversized estimates "
          "and leaves reservation windows empty; a learned p90 unlocks "
          "them.")
def _padded_estimates(num_jobs: int, seed: int) -> ScenarioRun:
    jobs = generate_trace("helios", num_jobs, seed=seed)
    rng = np.random.default_rng(seed + 808)
    if jobs:
        horizon = jobs[-1].submit_time
        t_spike = 0.5 * horizon
        crowd = rng.random(len(jobs)) < 0.30
        for j, hit in zip(jobs, crowd):
            if hit:
                j.submit_time = t_spike + float(rng.uniform(0.0, 600.0))
        jobs.sort(key=lambda j: j.submit_time)
    # each user pads by a *habitual* factor (people re-submit the same
    # walltime request), with mild per-job jitter — the per-(user, size)
    # structure the predictor's anchor debiasing learns
    users = sorted({j.user for j in jobs})
    pad = {int(u): float(rng.uniform(2.0, 8.0)) for u in users}
    for j in jobs:
        j.est_runtime = j.runtime * pad[j.user] * \
            float(rng.lognormal(0.0, 0.25))
    return ScenarioRun(name="padded-estimates",
                       spec=make_cluster("helios"), jobs=jobs)


@register("overcommit-queue",
          "Sustained overload on the Alibaba cluster — arrival intensity "
          "doubled through the middle of the stream — where every user "
          "habitually pads their walltime request 2-10x: the deep queue "
          "is full of backfill candidates blind estimate-gating cannot "
          "see.")
def _overcommit_queue(num_jobs: int, seed: int) -> ScenarioRun:
    jobs = generate_trace("alibaba", num_jobs, seed=seed)
    if jobs:
        horizon = jobs[-1].submit_time

        def rate(t: float) -> float:
            # mid-stream crunch: 2.2x intensity over the middle 40%
            return 2.2 if 0.3 * horizon < t < 0.7 * horizon else 0.6

        _warp_arrivals(jobs, rate)
    rng = np.random.default_rng(seed + 909)
    users = sorted({j.user for j in jobs})
    pad = {int(u): float(rng.uniform(2.0, 10.0)) for u in users}
    for j in jobs:
        j.est_runtime = j.runtime * pad[j.user] * \
            float(rng.lognormal(0.0, 0.25))
    return ScenarioRun(name="overcommit-queue",
                       spec=make_cluster("alibaba"), jobs=jobs)


@register("mispredict-storm",
          "Flash-crowd congestion with two-sided cohort mis-estimation: "
          "30% of users severely lowball (declared est 5-30% of truth) "
          "while 40% pad 3-8x — worst case for estimate-trusting backfill "
          "and the predictor's overrun band.")
def _mispredict_storm(num_jobs: int, seed: int) -> ScenarioRun:
    jobs = generate_trace("helios", num_jobs, seed=seed)
    rng = np.random.default_rng(seed + 707)
    if jobs:
        horizon = jobs[-1].submit_time
        t_spike = 0.5 * horizon
        crowd = rng.random(len(jobs)) < 0.30
        for j, hit in zip(jobs, crowd):
            if hit:
                j.submit_time = t_spike + float(rng.uniform(0.0, 600.0))
        jobs.sort(key=lambda j: j.submit_time)
    # user cohorts (not i.i.d. jobs) systematically mis-estimate — the
    # per-(user, size) structure is what the predictor can learn.  Liars
    # make blind backfill overcommit reservation windows; padders make it
    # leave them empty.
    users = sorted({j.user for j in jobs})
    k = max(1, int(0.3 * len(users)))
    perm = [int(u) for u in rng.permutation(users)]
    liars = frozenset(perm[:k])
    padders = frozenset(perm[k:k + max(1, int(0.4 * len(users)))])
    for j in jobs:
        if j.user in liars:
            j.est_runtime = max(60.0, j.runtime *
                                float(rng.uniform(0.05, 0.30)))
        elif j.user in padders:
            j.est_runtime = j.runtime * float(rng.uniform(3.0, 8.0))
    return ScenarioRun(name="mispredict-storm", spec=make_cluster("helios"),
                       jobs=jobs)


@register("sku-skew",
          "Demand concentrated on the scarce fast SKU: 60% of jobs demand "
          "V100 on a mostly-T4/P100 cluster.")
def _sku_skew(num_jobs: int, seed: int) -> ScenarioRun:
    jobs = generate_trace("alibaba", num_jobs, seed=seed)
    rng = np.random.default_rng(seed + 505)
    draws = rng.random(len(jobs))
    for j, u in zip(jobs, draws):
        j.gpu_type = "V100" if u < 0.60 else ("T4" if u < 0.85 else "any")
    return ScenarioRun(name="sku-skew", spec=make_cluster("alibaba"),
                       jobs=jobs)

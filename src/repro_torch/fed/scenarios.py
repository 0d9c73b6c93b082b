"""Fleet scenarios: heterogeneous multi-cluster workloads for the federation.

Each fleet scenario composes the existing registered single-cluster
scenarios (``repro_torch.sched.scenarios``) over a *fleet*: per-cluster specs and
fault models, plus one merged arrival stream the meta-scheduler routes.
Builders are deterministic in ``seed`` (same contract as the single-cluster
registry).

Registry: ``FLEET_SCENARIOS`` maps name -> ``FleetScenario``; use
``get_fleet_scenario(name)`` / ``list_fleet_scenarios()``.  Registered:

- ``fleet-steady``       — three identical clusters, merged steady streams
                           (control: any sane router ties here).
- ``fleet-skewed-flash`` — three size-skewed clusters (~0.5x / 1x / 2x)
                           serving merged flash-crowd streams; uniform
                           (hash) routing drowns the small cluster.
- ``fleet-fault-storm``  — one cluster in fault-storm while two stay
                           steady; load-aware routers drain around the
                           failing member.
- ``fleet-sku-split``    — a small fast A100 island next to a large V100
                           pool with SKU-skewed demand (affinity stress).
- ``fleet-multi-tenant`` — two clusters with skewed per-VC demand against
                           even quotas (exercises the per-engine VC-quota
                           gate across the fleet).
- ``fleet-fault-migration`` — a *harsh* storm (2h MTBF, 30-minute repairs)
                           on one member beside two healthy neighbours:
                           the queue piles up behind the storm, the case
                           ``repro_torch.lifecycle`` cross-cluster migration
                           exists to drain.
- ``fleet-blackout``     — one member loses *all* nodes mid-run for 15% of
                           the horizon (``repro_torch.chaos`` blackout): routers
                           degrade to the survivors, parked routes retry
                           with backoff when the member returns.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.faults import FaultModel
from repro_torch.core.trace import generate_trace, make_cluster
from repro_torch.core.types import ClusterSpec, Job, NodeSpec
from repro_torch.sched.scenarios import ScenarioRun, get_scenario


@dataclasses.dataclass(frozen=True)
class FleetRun:
    """A concrete, replayable fleet workload: clusters + merged job stream
    + per-cluster fault models + tenant metadata."""

    name: str
    clusters: tuple[ClusterSpec, ...]
    jobs: list[Job]
    fault_models: tuple
    sla_users: frozenset = frozenset()
    vc_quotas: dict | None = None
    #: optional fleet chaos timeline (a ``repro_torch.chaos.ChaosSchedule`` whose
    #: events carry member indices; duck-typed — ``run_fleet`` wraps it in
    #: a fresh ``FleetChaosInjector`` per run)
    chaos: object | None = None

    @classmethod
    def from_scenario(cls, run: ScenarioRun) -> "FleetRun":
        """Wrap a single-cluster ``ScenarioRun`` as a one-member fleet
        (the degenerate federation used by the differential tests)."""
        return cls(name=run.name, clusters=(run.spec,), jobs=run.jobs,
                   fault_models=(run.fault_model,), sla_users=run.sla_users,
                   vc_quotas=run.vc_quotas, chaos=run.chaos)

    @property
    def total_gpus(self) -> int:
        return sum(c.total_gpus for c in self.clusters)


@dataclasses.dataclass(frozen=True)
class FleetScenario:
    """A named fleet scenario: deterministic builder of FleetRuns."""

    name: str
    description: str
    build: Callable[[int, int], FleetRun]       # (num_jobs, seed) -> run


FLEET_SCENARIOS: dict[str, FleetScenario] = {}


def register_fleet(name: str, description: str):
    def deco(fn: Callable[[int, int], FleetRun]):
        FLEET_SCENARIOS[name] = FleetScenario(name=name,
                                              description=description,
                                              build=fn)
        return fn
    return deco


def get_fleet_scenario(name: str) -> FleetScenario:
    if name not in FLEET_SCENARIOS:
        raise KeyError(f"unknown fleet scenario {name!r}; registered: "
                       f"{', '.join(sorted(FLEET_SCENARIOS))}")
    return FLEET_SCENARIOS[name]


def list_fleet_scenarios() -> list[str]:
    return sorted(FLEET_SCENARIOS)


# ----------------------------------------------------------------- helpers ----


def merge_streams(streams: list[list[Job]]) -> list[Job]:
    """Merge per-scenario job streams into one fleet arrival stream: clones
    every job, orders by submit time (ties broken by stream position so the
    merge is deterministic), and re-ids jobs 0..n-1 so ids are unique
    fleet-wide (routing tables key on job_id)."""
    tagged = []
    for s_idx, stream in enumerate(streams):
        for j in stream:
            tagged.append((j.submit_time, s_idx, j.job_id, j.clone_pending()))
    tagged.sort(key=lambda t: t[:3])
    merged = []
    for i, (_, _, _, j) in enumerate(tagged):
        j.job_id = i
        merged.append(j)
    return merged


def _split(num_jobs: int, k: int) -> list[int]:
    """Split a job budget across k per-cluster streams (earlier streams get
    the remainder)."""
    base, rem = divmod(num_jobs, k)
    return [base + (1 if i < rem else 0) for i in range(k)]


def _rename(spec: ClusterSpec, name: str) -> ClusterSpec:
    spec.name = name
    return spec


def _helios_like(n_p100: int, n_v100: int, name: str) -> ClusterSpec:
    """A helios-class cluster scaled to an arbitrary node count (same SKUs
    and node shapes as ``make_cluster('helios')``)."""
    nodes = []
    for i in range(n_p100):
        nodes.append(NodeSpec(i, "P100", 8, 64, 512.0, 1.0))
    for i in range(n_v100):
        nodes.append(NodeSpec(n_p100 + i, "V100", 8, 64, 512.0, 1.5))
    return ClusterSpec(nodes=nodes, name=name)


# --------------------------------------------------------------- scenarios ----


@register_fleet("fleet-steady",
                "Three identical helios clusters serving merged steady "
                "streams — the control fleet where any sane router ties.")
def _fleet_steady(num_jobs: int, seed: int) -> FleetRun:
    k = 3
    clusters = tuple(_rename(make_cluster("helios"), f"helios-{i}")
                     for i in range(k))
    streams = [get_scenario("steady").build(n, seed + 17 * i).jobs
               for i, n in enumerate(_split(num_jobs, k))]
    return FleetRun(name="fleet-steady", clusters=clusters,
                    jobs=merge_streams(streams), fault_models=(None,) * k)


@register_fleet("fleet-skewed-flash",
                "Three size-skewed helios-class clusters (5/10/20 nodes) "
                "serving merged flash-crowd streams: uniform routing drowns "
                "the small cluster, load-aware routing must not.")
def _fleet_skewed_flash(num_jobs: int, seed: int) -> FleetRun:
    clusters = (_helios_like(2, 3, "helios-small"),
                _helios_like(5, 5, "helios-mid"),
                _helios_like(12, 8, "helios-large"))
    streams = [get_scenario("flash-crowd").build(n, seed + 31 * i).jobs
               for i, n in enumerate(_split(num_jobs, 3))]
    return FleetRun(name="fleet-skewed-flash", clusters=clusters,
                    jobs=merge_streams(streams), fault_models=(None,) * 3)


@register_fleet("fleet-fault-storm",
                "One philly cluster under fault-storm failure rates while "
                "two identical neighbours stay healthy — routers that read "
                "snapshots drain around the failing member.")
def _fleet_fault_storm(num_jobs: int, seed: int) -> FleetRun:
    runs = [get_scenario("fault-storm").build(n, seed + 7 * i)
            for i, n in enumerate(_split(num_jobs, 3))]
    clusters = tuple(_rename(runs[i].spec, f"philly-{i}") for i in range(3))
    # only cluster 0 actually suffers the storm; the others run fault-free
    return FleetRun(name="fleet-fault-storm", clusters=clusters,
                    jobs=merge_streams([r.jobs for r in runs]),
                    fault_models=(runs[0].fault_model, None, None))


@register_fleet("fleet-fault-migration",
                "A harsher fault storm on one member (2h MTBF, 30-minute "
                "repairs, heavy stragglers) beside two healthy neighbours — "
                "one-shot routing strands queued work behind the storm; "
                "cross-cluster migration re-homes it.")
def _fleet_fault_migration(num_jobs: int, seed: int) -> FleetRun:
    runs = [get_scenario("fault-storm").build(n, seed + 23 * i)
            for i, n in enumerate(_split(num_jobs, 3))]
    clusters = tuple(_rename(runs[i].spec, f"philly-{i}") for i in range(3))
    storm = FaultModel(mtbf_per_node=2 * 3600.0, repair_time=1800.0,
                       straggler_prob=0.4, straggler_slowdown=0.4,
                       ckpt_interval=900.0, seed=seed + 808)
    return FleetRun(name="fleet-fault-migration", clusters=clusters,
                    jobs=merge_streams([r.jobs for r in runs]),
                    fault_models=(storm, None, None))


@register_fleet("fleet-blackout",
                "Three helios-like members; member 0 blacks out entirely at "
                "35% of the horizon and returns 15% later — the federation "
                "chaos stress (offline routing + deferred-route backoff).")
def _fleet_blackout(num_jobs: int, seed: int) -> FleetRun:
    from repro_torch.chaos import ChaosSchedule
    k = 3
    clusters = tuple(_helios_like(3, 3, f"helios-bo-{i}") for i in range(k))
    streams = [get_scenario("steady").build(n, seed + 41 * i).jobs
               for i, n in enumerate(_split(num_jobs, k))]
    jobs = merge_streams(streams)
    horizon = jobs[-1].submit_time if jobs else 86400.0
    chaos = ChaosSchedule().add_blackout(0.35 * horizon, cluster=0,
                                         duration=0.15 * horizon)
    return FleetRun(name="fleet-blackout", clusters=clusters, jobs=jobs,
                    fault_models=(None,) * k, chaos=chaos)


@register_fleet("fleet-sku-split",
                "A small fast A100 island (3 nodes) next to a large V100 "
                "pool (16 nodes); 20% of demand asks for A100, 45% V100, "
                "35% flexible — SKU-affinity stress.")
def _fleet_sku_split(num_jobs: int, seed: int) -> FleetRun:
    a100 = ClusterSpec([NodeSpec(i, "A100", 8, 96, 1024.0, 3.0)
                        for i in range(3)], name="a100-island")
    v100 = ClusterSpec([NodeSpec(i, "V100", 8, 64, 512.0, 1.5)
                        for i in range(16)], name="v100-pool")
    streams = [generate_trace("alibaba", n, seed=seed + 13 * i)
               for i, n in enumerate(_split(num_jobs, 2))]
    jobs = merge_streams(streams)
    rng = np.random.default_rng(seed + 606)
    draws = rng.random(len(jobs))
    for j, u in zip(jobs, draws):
        j.gpu_type = "A100" if u < 0.20 else ("V100" if u < 0.65 else "any")
    return FleetRun(name="fleet-sku-split", clusters=(a100, v100), jobs=jobs,
                    fault_models=(None, None))


@register_fleet("fleet-multi-tenant",
                "Two alibaba clusters with skewed per-VC demand "
                "(55/25/12/8%) against even 25% quotas: every engine runs "
                "its own incremental VC-quota gate.")
def _fleet_multi_tenant(num_jobs: int, seed: int) -> FleetRun:
    runs = [get_scenario("multi-tenant").build(n, seed + 11 * i)
            for i, n in enumerate(_split(num_jobs, 2))]
    clusters = tuple(_rename(runs[i].spec, f"alibaba-{i}") for i in range(2))
    return FleetRun(name="fleet-multi-tenant", clusters=clusters,
                    jobs=merge_streams([r.jobs for r in runs]),
                    fault_models=(None, None), vc_quotas=runs[0].vc_quotas)

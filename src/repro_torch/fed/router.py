"""Snapshot-driven routing policies for the multi-cluster federation layer.

A ``Router`` decides, at submit time, which cluster's ``SchedulerEngine``
receives an arriving job.  The **snapshot-only routing invariant**: a router
sees exactly two things per cluster —

- ``ClusterInfo``: static capacity (total GPUs, per-SKU totals), computed
  once from the ``ClusterSpec``;
- the latest ``EngineSnapshot``: the O(1) view the engine already exports
  (queue depth, free GPUs overall and per SKU, utilization, ...).

Routers never touch engine internals, never enumerate placements, and never
profile jobs — exactly the cheap-rolling-signal regime online schedulers
like PADS argue for — so routing one job is O(N) in the number of clusters
regardless of cluster size or queue depth.

All routers restrict their choice to *capable* clusters (enough total GPUs
of the requested SKU that the job could ever be placed there); a job no
cluster can ever run degrades to the largest-capacity cluster for its SKU
instead of crashing the router.  Snapshot-derived ratios arrive pre-hardened
(see ``EngineSnapshot``): a fleet member whose nodes have all failed reads
zero free GPUs and finite utilization, never NaN.

Registered policies (``ROUTERS`` / ``make_router``):

- ``jsq``             — join-shortest-queue on jobs in the system.
- ``free-gpus``       — most free GPUs on up nodes right now.
- ``sku-affinity``    — prefer clusters whose SKU mix can serve the job's
                        GPU request *now* (most free GPUs of that SKU);
                        falls back to shortest-queue among capable clusters
                        when no cluster currently has the SKU free.
- ``weighted-random`` — random, weighted by static cluster capacity
                        (deterministic in its seed).
- ``hash``            — stateless multiplicative hash of the job id; the
                        baseline every stateful policy must beat.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence

import numpy as np

from repro_torch.core.types import ClusterSpec, Job
from repro_torch.sched.engine import EngineSnapshot

#: Knuth's multiplicative hashing constant (2^32 / phi), used by the
#: stateless ``hash`` router to spread sequential job ids uniformly.
_KNUTH = 2654435761


@dataclasses.dataclass(frozen=True)
class ClusterInfo:
    """Static, routing-visible description of one fleet member."""

    index: int
    name: str
    total_gpus: int
    total_by_type: dict

    @classmethod
    def from_spec(cls, index: int, spec: ClusterSpec) -> "ClusterInfo":
        return cls(index=index, name=spec.name, total_gpus=spec.total_gpus,
                   total_by_type={t: spec.gpus_of_type(t)
                                  for t in spec.gpu_types})

    def capacity_for(self, gpu_type: str) -> int:
        """Total GPUs this cluster could ever offer the requested SKU."""
        if gpu_type == "any":
            return self.total_gpus
        return self.total_by_type.get(gpu_type, 0)


@dataclasses.dataclass
class ClusterView:
    """What the router sees for one cluster: static info + latest snapshot.

    The federation refreshes the routed cluster's snapshot after every
    accepted job, so ``snap.submitted`` already counts jobs routed earlier
    in the same batch."""

    info: ClusterInfo
    snap: EngineSnapshot

    @property
    def queue_load(self) -> int:
        """Jobs currently in this cluster's system: pending + running +
        routed-but-not-yet-arrived.  Equals ``EngineSnapshot.in_flight`` at
        every rescan-window edge (once the engine has stepped past the
        arrivals); between edges it additionally counts jobs routed here
        since the engine last stepped — without it, JSQ would dump a whole
        burst on whichever cluster looked shortest at the window open."""
        return self.snap.submitted - self.snap.num_completed

    def free_for(self, gpu_type: str) -> int:
        """Free GPUs on up nodes satisfying the requested SKU, right now."""
        if gpu_type == "any":
            return self.snap.free_gpus
        return self.snap.free_gpus_by_type.get(gpu_type, 0)


class Router(Protocol):
    """Routing policy: pick the cluster index an arriving job is sent to.

    ``views[i].info.index == i`` — the federation passes views in cluster
    order, and the returned index addresses that same list."""

    name: str

    def route(self, job: Job, views: Sequence[ClusterView]) -> int: ...


def capable_clusters(job: Job, views: Sequence[ClusterView]) -> list[int]:
    """Indices of clusters that could EVER place the job (enough total GPUs
    of the requested SKU).  When none qualifies, degrade to the single
    largest-capacity cluster for that SKU (ties: overall capacity, then
    lowest index) — a mis-sized job turns into one hot queue, not a crash."""
    cap = [v.info.index for v in views
           if v.info.capacity_for(job.gpu_type) >= job.num_gpus]
    if cap:
        return cap
    best = max(views, key=lambda v: (v.info.capacity_for(job.gpu_type),
                                     v.info.total_gpus, -v.info.index))
    return [best.info.index]


class HashRouter:
    """Stateless baseline: multiplicative hash of the job id over the
    capable set.  Uniform regardless of cluster size or load — exactly the
    blindness the stateful policies are benchmarked against."""

    name = "hash"

    def route(self, job: Job, views: Sequence[ClusterView]) -> int:
        cap = capable_clusters(job, views)
        return cap[((job.job_id * _KNUTH) & 0xFFFFFFFF) % len(cap)]


class JSQRouter:
    """Join-shortest-queue on jobs in the system (ties: lowest index)."""

    name = "jsq"

    def route(self, job: Job, views: Sequence[ClusterView]) -> int:
        cap = capable_clusters(job, views)
        return min(cap, key=lambda i: (views[i].queue_load, i))


class FreeGpusRouter:
    """Most free GPUs on up nodes right now (ties: lowest index)."""

    name = "free-gpus"

    def route(self, job: Job, views: Sequence[ClusterView]) -> int:
        cap = capable_clusters(job, views)
        return min(cap, key=lambda i: (-views[i].snap.free_gpus, i))


class SkuAffinityRouter:
    """Prefer clusters whose SKU mix serves the request *now*: among capable
    clusters with >= num_gpus of the requested SKU free, take the one with
    the most free (ties: lowest index).  When no cluster currently has the
    SKU free — the job will queue wherever it lands — fall back to the
    shortest queue among capable clusters."""

    name = "sku-affinity"

    def route(self, job: Job, views: Sequence[ClusterView]) -> int:
        cap = capable_clusters(job, views)
        fit = [i for i in cap if views[i].free_for(job.gpu_type) >= job.num_gpus]
        if fit:
            return min(fit, key=lambda i: (-views[i].free_for(job.gpu_type), i))
        return min(cap, key=lambda i: (views[i].queue_load, i))


class WeightedRandomRouter:
    """Random over capable clusters, weighted by static total capacity;
    deterministic in ``seed``.  Zero/degenerate weights fall back to a
    uniform draw (an all-zero fleet must not produce NaN probabilities)."""

    name = "weighted-random"

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def route(self, job: Job, views: Sequence[ClusterView]) -> int:
        cap = capable_clusters(job, views)
        if len(cap) == 1:
            return cap[0]
        w = np.array([views[i].info.total_gpus for i in cap], dtype=np.float64)
        tot = float(w.sum())
        if not np.isfinite(tot) or tot <= 0.0:
            return cap[int(self._rng.integers(len(cap)))]
        return cap[int(self._rng.choice(len(cap), p=w / tot))]


ROUTERS: dict[str, type] = {
    "hash": HashRouter,
    "jsq": JSQRouter,
    "free-gpus": FreeGpusRouter,
    "sku-affinity": SkuAffinityRouter,
    "weighted-random": WeightedRandomRouter,
}


def list_routers() -> list[str]:
    return sorted(ROUTERS)


def make_router(router: Router | str, seed: int = 0) -> Router:
    """Resolve a router by registry name (pass-through for instances)."""
    if not isinstance(router, str):
        return router
    if router not in ROUTERS:
        raise KeyError(f"unknown router {router!r}; "
                       f"registered: {', '.join(sorted(ROUTERS))}")
    cls = ROUTERS[router]
    return cls(seed=seed) if cls is WeightedRandomRouter else cls()

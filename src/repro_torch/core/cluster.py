"""Runtime cluster state: allocation tracking + placement enumeration.

The cluster tracks free GPUs/CPUs/memory per node, supports gang allocation
across nodes, and enumerates candidate placements ("ways") for a job:

- way1 "spread": prefer empty / least-loaded nodes (isolation, low contention)
- way2 "pack":   prefer most-loaded nodes that still fit (utilization)

The MILP module (Algorithm 1 of the paper) chooses between them.

Versioned feasibility cache
---------------------------
Every mutation (``allocate`` / ``release`` / ``fail_node`` / ``recover_node``
/ ``load_from``) bumps ``version``.  With ``cache=True`` the placement
queries (``find_placement`` / ``candidate_ways`` / ``can_schedule_now``),
the SKU eligibility masks, and the per-SKU free-GPU tallies are memoized per
(job shape, version): between two mutations a saturated scheduler re-asks the
same feasibility questions for the whole queue window, and every repeat is a
dict hit instead of a placement search.  Job "shape" is the tuple of fields
placement actually depends on: ``(num_gpus, gpu_type, req_cpus, req_mem_gb)``.

Caching is opt-out by default because callers that mutate the resource arrays
directly (some tests do) would otherwise read stale entries; the scheduler
engine owns its ``ClusterState`` and constructs it with ``cache=True``.

Elastic capacity
----------------
The autoscaling layer (``repro_torch.scale``) mutates capacity at runtime:

- ``add_node(spec)`` appends a node (arrays grow, SKU masks rebuild) and
  returns its node id; ids are stable for the cluster's lifetime.
- ``remove_node(node_id)`` retires an idle node immediately; a busy node is
  **cordoned** instead (drain semantics): excluded from placement and the
  feasibility tallies, but its running jobs keep their GPUs and the node
  still counts as *provisioned*.  Once its last allocation is released the
  node auto-retires.  ``uncordon_node`` cancels a pending drain (scale-up
  reuses draining nodes before adding new ones).
- retired nodes are permanently excluded everywhere (placement, tallies,
  utilization, provisioned totals) but keep their array slot so node ids in
  live placements never shift.

Every capacity mutation bumps ``topo_version`` (and therefore ``version``)
exactly like ``fail_node``/``recover_node``, so the per-version feasibility
caches and memoized ratios can never serve pre-mutation answers.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.types import ClusterSpec, Job, NodeSpec

Placement = dict[int, int]  # node_id -> gpus taken

_MISS = object()   # cache sentinel (cached values may legitimately be None)


def _job_shape(job: Job) -> tuple:
    """The fields placement feasibility depends on — the cache key."""
    return (job.num_gpus, job.gpu_type, job.req_cpus, job.req_mem_gb)


class JobShape(NamedTuple):
    """A ``_job_shape`` key with its fields named.  It equals and hashes as
    the plain key, and the placement queries (``candidate_ways``,
    ``find_placement``, ``num_ways_to_schedule``) read only these four
    fields, so a shape stands in for any job of that shape there."""

    num_gpus: int
    gpu_type: str
    req_cpus: int
    req_mem_gb: float


class ClusterState:
    """Mutable multi-resource state of a heterogeneous cluster."""

    def __init__(self, spec: ClusterSpec, cache: bool = False):
        self.spec = spec
        n = len(spec.nodes)
        self.free_gpus = np.array([nd.num_gpus for nd in spec.nodes], dtype=np.int64)
        self.free_cpus = np.array([nd.num_cpus for nd in spec.nodes], dtype=np.int64)
        self.free_mem = np.array([nd.mem_gb for nd in spec.nodes], dtype=np.float64)
        self.gpu_types = np.array([nd.gpu_type for nd in spec.nodes])
        self.speeds = np.array([nd.speed for nd in spec.nodes], dtype=np.float64)
        self.total_gpus = np.array([nd.num_gpus for nd in spec.nodes], dtype=np.int64)
        self.node_down = np.zeros(n, dtype=bool)   # fault injection
        self.cordoned = np.zeros(n, dtype=bool)    # draining for removal
        self.retired = np.zeros(n, dtype=bool)     # removed (slot kept)
        # per-SKU node-index masks (rebuilt only when add_node grows the
        # cluster; a node's SKU never changes in place)
        self._rebuild_static_masks()
        # version counters: `version` bumps on every mutation; `topo_version`
        # only when node up/down topology changes (eligibility masks depend
        # solely on topology, not on free-resource levels)
        self.version = 0
        self.topo_version = 0
        self.cache_enabled = bool(cache)
        self._placement_cache: dict[tuple, Placement | None] = {}
        self._ways_cache: dict[tuple, list[Placement]] = {}
        self._eligible_cache: dict[str, np.ndarray] = {}
        self._tallies: tuple[int, dict[str, int]] | None = None
        self._up_ratios: tuple[float, float] | None = None
        self._prov_totals: tuple[int, tuple[int, dict[str, int]]] | None = None

    def _rebuild_static_masks(self) -> None:
        n = len(self.gpu_types)
        self._sku_masks: dict[str, np.ndarray] = {
            t: self.gpu_types == t for t in set(str(t) for t in self.gpu_types)}
        self._all_mask = np.ones(n, dtype=bool)
        self._no_mask = np.zeros(n, dtype=bool)
        self._total_by_type = {t: int(self.total_gpus[m].sum())
                               for t, m in self._sku_masks.items()}

    # ---------------------------------------------------------------- caching --
    def _bump(self) -> None:
        self.version += 1
        if self._placement_cache:
            self._placement_cache.clear()
        if self._ways_cache:
            self._ways_cache.clear()
        self._tallies = None
        self._up_ratios = None

    def _bump_topology(self) -> None:
        self.topo_version += 1
        if self._eligible_cache:
            self._eligible_cache.clear()
        self._bump()

    def load_from(self, other: "ClusterState") -> None:
        """Copy the mutable resource state of ``other`` in place (scratch
        reuse for what-if simulation) and invalidate all caches.  Requires
        equal node counts — scratch owners rebuild when ``add_node`` grew
        the source cluster."""
        np.copyto(self.free_gpus, other.free_gpus)
        np.copyto(self.free_cpus, other.free_cpus)
        np.copyto(self.free_mem, other.free_mem)
        np.copyto(self.node_down, other.node_down)
        np.copyto(self.cordoned, other.cordoned)
        np.copyto(self.retired, other.retired)
        self._bump_topology()

    # ------------------------------------------------------------------ queries --
    def eligible_mask(self, gpu_type: str) -> np.ndarray:
        """Boolean mask of up nodes whose SKU satisfies ``gpu_type``.
        Callers must treat the returned array as read-only."""
        if self.cache_enabled:
            m = self._eligible_cache.get(gpu_type)
            if m is None:
                m = self._compute_eligible(gpu_type)
                self._eligible_cache[gpu_type] = m
            return m
        return self._compute_eligible(gpu_type)

    def _compute_eligible(self, gpu_type: str) -> np.ndarray:
        base = self._all_mask if gpu_type == "any" \
            else self._sku_masks.get(gpu_type, self._no_mask)
        return base & self.placeable_mask()

    def placeable_mask(self) -> np.ndarray:
        """Up, not draining, not removed: the nodes placement may use.
        Shared by the engine's schedulability prefilter, the RL feature
        builder, and the autoscaler's idle-capacity scan.  Treat the
        returned array as read-only."""
        return ~(self.node_down | self.cordoned | self.retired)

    def nodes_for(self, job: Job) -> np.ndarray:
        """Boolean mask of nodes whose SKU satisfies the job's request and are up."""
        return self.eligible_mask(job.gpu_type)

    def sku_mask(self, gpu_type: str) -> np.ndarray:
        """Static boolean node mask for one SKU (``any`` = all nodes);
        ignores up/cordon/retire state.  Treat as read-only."""
        if gpu_type == "any":
            return self._all_mask
        return self._sku_masks.get(gpu_type, self._no_mask)

    def free_gpu_tallies(self) -> tuple[int, dict[str, int]]:
        """``(total_free_placeable, {sku: free_gpus_placeable})`` over up,
        non-cordoned, non-retired nodes — cached per version so
        saturated-queue prefilters are O(1)."""
        if self.cache_enabled and self._tallies is not None:
            return self._tallies
        up = self.placeable_mask()
        total = int(self.free_gpus[up].sum())
        by_type = {t: int(self.free_gpus[m & up].sum())
                   for t, m in self._sku_masks.items()}
        tallies = (total, by_type)
        if self.cache_enabled:
            self._tallies = tallies
        return tallies

    def free_gpus_of_type(self, gpu_type: str) -> int:
        total, by_type = self.free_gpu_tallies()
        return total if gpu_type == "any" else by_type.get(gpu_type, 0)

    def total_gpus_of_type(self, gpu_type: str) -> int:
        if gpu_type == "any":
            return int(self.total_gpus.sum())
        return self._total_by_type.get(gpu_type, 0)

    def _fits_node(self, job: Job, i: int, gpus: int) -> bool:
        """Would `gpus` GPUs of `job` fit on node i respecting CPU/mem coupling?"""
        if gpus <= 0 or gpus > self.free_gpus[i]:
            return False
        frac = gpus / max(job.num_gpus, 1)
        return (self.free_cpus[i] >= round(job.req_cpus * frac)
                and self.free_mem[i] >= job.req_mem_gb * frac)

    def can_schedule_now(self, job: Job) -> bool:
        return self.find_placement(job, mode="pack") is not None

    # -------------------------------------------------------------- placements --
    def find_placement(self, job: Job, mode: str = "pack") -> Placement | None:
        """Greedy gang placement. mode: 'pack' (most-loaded-first) or
        'spread' (least-loaded-first / fewest co-tenants)."""
        if self.cache_enabled:
            key = (job.num_gpus, job.gpu_type, job.req_cpus, job.req_mem_gb,
                   mode)
            hit = self._placement_cache.get(key, _MISS)
            if hit is not _MISS:
                return hit
            p = self._find_placement(job, mode)
            self._placement_cache[key] = p
            return p
        return self._find_placement(job, mode)

    def _find_placement(self, job: Job, mode: str) -> Placement | None:
        eligible = self.nodes_for(job)
        order = np.argsort(self.free_gpus if mode == "pack" else -self.free_gpus,
                           kind="stable")
        need = job.num_gpus
        placement: Placement = {}
        for i in order:
            if not eligible[i] or need <= 0:
                continue
            take = int(min(need, self.free_gpus[i]))
            # shrink until CPU/mem coupling fits
            while take > 0 and not self._fits_node(job, int(i), take):
                take -= 1
            if take > 0:
                placement[int(i)] = take
                need -= take
        return placement if need == 0 else None

    def candidate_ways(self, job: Job) -> list[Placement]:
        """Distinct candidate placements (spread & pack at minimum)."""
        if self.cache_enabled:
            key = _job_shape(job)
            hit = self._ways_cache.get(key, _MISS)
            if hit is not _MISS:
                return hit
            ways = self._candidate_ways(job)
            self._ways_cache[key] = ways
            return ways
        return self._candidate_ways(job)

    def _candidate_ways(self, job: Job) -> list[Placement]:
        ways: list[Placement] = []
        for mode in ("spread", "pack"):
            p = self.find_placement(job, mode)
            if p is not None and p not in ways:
                ways.append(p)
        # single-node way if the job fits whole on one eligible node
        eligible = self.nodes_for(job)
        for i in np.argsort(self.free_gpus, kind="stable"):
            if eligible[i] and self._fits_node(job, int(i), job.num_gpus):
                p = {int(i): job.num_gpus}
                if p not in ways:
                    ways.append(p)
                break
        return ways

    def num_ways_to_schedule(self, job: Job) -> int:
        return len(self.candidate_ways(job))

    # -------------------------------------------------------------- mutation ----
    def allocate(self, job: Job, placement: Placement) -> None:
        # validate the whole gang before mutating anything: a mid-loop
        # failure must not leave a partially-decremented cluster behind a
        # still-valid cache version (guards are RuntimeErrors, not asserts,
        # so they survive `python -O`)
        for i, g in placement.items():
            frac = g / max(job.num_gpus, 1)
            if self.free_gpus[i] < g:
                raise RuntimeError(f"GPU oversubscription on node {i}")
            if (self.free_cpus[i] < round(job.req_cpus * frac)
                    or self.free_mem[i] < job.req_mem_gb * frac - 1e-9):
                raise RuntimeError(f"CPU/mem oversubscription on node {i}")
        for i, g in placement.items():
            frac = g / max(job.num_gpus, 1)
            self.free_gpus[i] -= g
            self.free_cpus[i] -= round(job.req_cpus * frac)
            self.free_mem[i] -= job.req_mem_gb * frac
        self._bump()

    def release(self, job: Job, placement: Placement) -> None:
        for i, g in placement.items():
            if self.free_gpus[i] + g > self.total_gpus[i]:
                raise RuntimeError(f"double release on node {i}")
        drained = False
        for i, g in placement.items():
            frac = g / max(job.num_gpus, 1)
            self.free_gpus[i] += g
            self.free_cpus[i] += round(job.req_cpus * frac)
            self.free_mem[i] += job.req_mem_gb * frac
            # drain semantics: a cordoned node whose last allocation just
            # left retires on the spot (capacity leaves the provisioned pool)
            if self.cordoned[i] and self.free_gpus[i] == self.total_gpus[i]:
                self.cordoned[i] = False
                self.retired[i] = True
                drained = True
        if drained:
            self._bump_topology()
        else:
            self._bump()

    def placement_speed(self, placement: Placement) -> float:
        """Effective speed of a gang placement = slowest member SKU."""
        return float(min(self.speeds[i] for i in placement)) if placement else 1.0

    # ------------------------------------------------------------------ faults --
    def fail_node(self, node_id: int) -> None:
        self.node_down[node_id] = True
        self._bump_topology()

    def recover_node(self, node_id: int) -> None:
        self.node_down[node_id] = False
        self._bump_topology()

    # -------------------------------------------------------- elastic capacity --
    def add_node(self, node: NodeSpec) -> int:
        """Append a node (autoscaling scale-up).  The given spec's
        ``node_id`` is ignored; the assigned id (== array index) is
        returned and also recorded in ``spec.nodes`` so rebuilt scratch
        clusters see the same topology."""
        nid = len(self.spec.nodes)
        node = NodeSpec(node_id=nid, gpu_type=node.gpu_type,
                        num_gpus=node.num_gpus, num_cpus=node.num_cpus,
                        mem_gb=node.mem_gb, speed=node.speed)
        self.spec.nodes.append(node)
        self.free_gpus = np.append(self.free_gpus, node.num_gpus)
        self.free_cpus = np.append(self.free_cpus, node.num_cpus)
        self.free_mem = np.append(self.free_mem, node.mem_gb)
        self.gpu_types = np.append(self.gpu_types, node.gpu_type)
        self.speeds = np.append(self.speeds, node.speed)
        self.total_gpus = np.append(self.total_gpus, node.num_gpus)
        self.node_down = np.append(self.node_down, False)
        self.cordoned = np.append(self.cordoned, False)
        self.retired = np.append(self.retired, False)
        self._rebuild_static_masks()
        self._bump_topology()
        return nid

    def remove_node(self, node_id: int) -> bool:
        """Retire a node (autoscaling scale-down).  An idle node retires
        immediately (returns ``True``); a node with live allocations is
        cordoned instead — excluded from placement but still provisioned —
        and auto-retires when its last job releases (returns ``False``)."""
        if not 0 <= node_id < len(self.total_gpus):
            raise ValueError(f"no such node {node_id}")
        if self.retired[node_id]:
            raise ValueError(f"node {node_id} already retired")
        if self.free_gpus[node_id] == self.total_gpus[node_id]:
            self.cordoned[node_id] = False
            self.retired[node_id] = True
            self._bump_topology()
            return True
        self.cordoned[node_id] = True
        self._bump_topology()
        return False

    def uncordon_node(self, node_id: int) -> None:
        """Cancel a pending drain (scale-up re-admits a draining node
        before paying for a fresh one).  No-op unless cordoned."""
        if self.cordoned[node_id]:
            self.cordoned[node_id] = False
            self._bump_topology()

    def provisioned_gpu_totals(self) -> tuple[int, dict[str, int]]:
        """``(total, {sku: total})`` GPUs on non-retired nodes — the
        capacity currently paid for (cordoned/draining nodes included).
        Memoized per ``topo_version`` (capacity only moves on topology
        mutations, never on allocate/release that doesn't drain a cordon)."""
        if self._prov_totals is not None \
                and self._prov_totals[0] == self.topo_version:
            return self._prov_totals[1]
        mask = ~self.retired
        totals = (int(self.total_gpus[mask].sum()),
                  {t: int(self.total_gpus[m & mask].sum())
                   for t, m in self._sku_masks.items()})
        self._prov_totals = (self.topo_version, totals)
        return totals

    # ------------------------------------------------------------------ stats ---
    def _up_ratio_pair(self) -> tuple[float, float]:
        """(utilization, fragmentation) over up nodes — memoized per version
        so per-job snapshot refreshes during a routed burst (no cluster
        mutation in between) are dict hits, not O(nodes) reductions.

        Utilization counts up *provisioned* nodes (cordoned nodes still
        hold busy GPUs the operator pays for); fragmentation counts only
        placeable free GPUs (free capacity on a draining node cannot host
        anything, so it must not read as usable-but-fragmented)."""
        if self.cache_enabled and self._up_ratios is not None:
            return self._up_ratios
        up = ~(self.node_down | self.retired)
        tot = int(self.total_gpus[up].sum())
        total_busy = float((self.total_gpus[up] - self.free_gpus[up]).sum())
        util = total_busy / tot if tot > 0 else 0.0
        free = self.free_gpus[up & ~self.cordoned]
        total_free = float(free.sum())
        frag = 0.0
        if total_free > 0:
            # sum of squares is maximal when all free GPUs sit on one node
            frag = 1.0 - float((free.astype(np.float64) ** 2).sum()) \
                / (total_free ** 2)
        pair = (util, frag)
        if self.cache_enabled:
            self._up_ratios = pair
        return pair

    def utilization(self, up_only: bool = False) -> float:
        """Busy-GPU fraction.  ``up_only`` restricts both numerator and
        denominator to up nodes — the view a federation router should see,
        where a fully-failed cluster reads 0.0 instead of dividing by its
        vanished capacity.  Guarded against zero-GPU / empty clusters."""
        if up_only:
            return self._up_ratio_pair()[0]
        mask = ~self.retired
        tot = int(self.total_gpus[mask].sum())
        return float((self.total_gpus[mask] - self.free_gpus[mask]).sum()
                     / max(tot, 1))

    def fragmentation(self, up_only: bool = False) -> float:
        """Cluster Fragmentation Factor, Eq. (3) (normalized to [0, 1]).
        ``up_only`` ignores free GPUs stranded on down nodes (they are not
        placeable, so they should not read as usable-but-fragmented).
        Returns 0.0 for zero-free / zero-GPU / empty clusters."""
        if up_only:
            return self._up_ratio_pair()[1]
        free = self.free_gpus[~self.retired]
        total_free = float(free.sum())
        if total_free <= 0:
            return 0.0
        # sum of squares is maximal when all free GPUs sit on one node
        conc = float((free.astype(np.float64) ** 2).sum()) \
            / (total_free ** 2)
        return 1.0 - conc

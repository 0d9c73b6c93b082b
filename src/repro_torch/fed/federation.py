"""Multi-cluster federation: a meta-scheduler over per-cluster engines.

``FederatedScheduler`` owns N independent ``SchedulerEngine`` instances —
one per cluster, each with its own ``ClusterSpec``, prioritizer, allocator,
and fault model — and routes every arriving job to exactly one engine at
submit time.  After routing, clusters never interact: engines advance in
**lockstep rescan windows** (``step(until)`` steps every engine to the same
time bound, the ``service.py`` windowed-stepping contract), so a fleet of N
clusters behaves like N independent streams stitched together by the router.

Two invariants make the layer cheap and predictable:

- **Snapshot-only routing** (see ``repro_torch.fed.router``): the router reads
  static ``ClusterInfo`` plus the latest ``EngineSnapshot`` per cluster —
  O(N) per job, independent of queue depth or cluster size.  The federation
  refreshes the routed cluster's snapshot after each accepted job, so
  burst arrivals within one window see their own effect on queue loads.
- **Window-edge equivalence**: engines only advance inside ``step`` /
  ``drain``, and scheduling happens at event instants, so *given a fixed
  routing assignment* lockstep windowed stepping is exactly equivalent to
  draining each engine independently.  A single-cluster federation with the
  stateless ``hash`` router is therefore bit-identical to a bare
  ``SchedulerEngine`` (pinned by differential tests).  Load-aware routers
  legitimately route differently under different rescan cadences — the
  snapshots they read evolve with the windows.

Observability: each engine carries its own ``RollingTelemetry`` hook;
``FleetSnapshot`` aggregates O(1) per-cluster snapshots (fleet utilization,
cross-cluster Jain fairness, routed-job distribution) and ``result()``
folds completed jobs into a ``FleetResult`` with fleet-wide JCT / wait
percentiles and per-cluster ``BatchResult``s.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Sequence

import numpy as np

from repro_torch.core.metrics import BatchResult
from repro_torch.core.policies import make_policy
from repro_torch.core.prioritizer import PolicyPrioritizer, Prioritizer
from repro_torch.core.types import ClusterSpec, Job
from repro_torch.fed.router import ClusterInfo, ClusterView, Router, make_router
from repro_torch.fed.scenarios import FleetRun, get_fleet_scenario
from repro_torch.sched.engine import MultiHooks, SchedulerEngine
from repro_torch.sched.service import QuotaPrioritizer, wrap_tenancy
from repro_torch.sched.telemetry import RollingTelemetry, jain_index


@dataclasses.dataclass(frozen=True)
class FleetSnapshot:
    """O(1) fleet-wide view: per-cluster snapshots plus aggregates.

    ``utilization`` is the capacity-weighted mean of per-cluster (up-node)
    utilizations and ``fairness`` is Jain's index over them; both are
    guarded so zero-GPU fleets and all-failed members yield finite values.
    """

    now: float
    clusters: tuple
    routed: tuple
    submitted: int
    num_pending: int
    num_running: int
    num_completed: int
    free_gpus: int
    utilization: float
    fairness: float

    @property
    def in_flight(self) -> int:
        return self.num_pending + self.num_running


@dataclasses.dataclass
class FleetResult:
    """End-of-run fleet aggregate over everything completed so far."""

    per_cluster: list[BatchResult]
    routed: list[int]
    jobs: list[Job]                    # completed, fleet-wide
    makespan: float
    gpu_seconds_used: float
    utilization: float                 # used / (fleet GPUs * makespan)
    avg_jct: float
    avg_wait: float
    jct_p50: float
    jct_p99: float
    wait_p50: float
    wait_p99: float
    fairness: float                    # Jain over per-cluster GPU-seconds/GPU


def _pct(arr: np.ndarray | None, q: float) -> float:
    return float(np.percentile(arr, q)) if arr is not None and arr.size else 0.0


#: Deferred-route retry backoff: first retry after DEFER_BASE_S, doubling
#: per failed attempt up to DEFER_MAX_S; after DEFER_MAX_ATTEMPTS the job is
#: force-routed onto the best surviving member even if nominally too big
#: for any of them (it then waits in that member's queue like any other
#: temporarily-unplaceable job).
DEFER_BASE_S = 60.0
DEFER_MAX_S = 3600.0
DEFER_MAX_ATTEMPTS = 8


class FederatedScheduler:
    """Meta-scheduler routing a shared job stream across per-cluster engines.

    ``prioritizer_factory(i)`` builds cluster ``i``'s prioritizer — engines
    must never share prioritizer state (a ``QuotaPrioritizer``'s usage
    tracking is per engine, so the factory is called once per cluster).
    ``QuotaPrioritizer`` instances are wired exactly like ``run_stream``
    does: attached as the engine's hook (incremental usage) and handed the
    engine reference for the recompute reference path.
    """

    def __init__(
        self,
        clusters: Sequence[ClusterSpec],
        router: Router | str = "jsq",
        *,
        prioritizer_factory: Callable[[int], Prioritizer] | None = None,
        allocator: str = "milp",
        backfill: bool = True,
        lookahead_k: int = 8,
        fault_models: Sequence | None = None,
        queue_window: int | None = None,
        telemetry: bool = True,
        telemetry_window: float = 6 * 3600.0,
        sample_interval: float = 600.0,
        router_seed: int = 0,
        optimized: bool = True,
        autoscalers: Sequence | None = None,
        migration=None,
        obs=None,
        parallel: bool = False,
        predictors: Sequence | None = None,
    ):
        if not clusters:
            raise ValueError("a federation needs at least one cluster")
        #: fleet-level observability bundle (repro_torch.obs.Observability):
        #: members get per-cluster child bundles (disjoint trace pids, own
        #: metric labels) and routing / deferral / migration / blackout
        #: decisions count on the fleet registry.  None = bit-identical to
        #: the un-instrumented federation (pinned by tests).
        self.obs = obs
        fms = list(fault_models) if fault_models is not None \
            else [None] * len(clusters)
        if len(fms) != len(clusters):
            raise ValueError(f"{len(clusters)} clusters but {len(fms)} "
                             f"fault models")
        self.autoscalers = list(autoscalers) if autoscalers is not None \
            else [None] * len(clusters)
        if len(self.autoscalers) != len(clusters):
            raise ValueError(f"{len(clusters)} clusters but "
                             f"{len(self.autoscalers)} autoscalers")
        #: per-member runtime predictors (repro_torch.predict.RuntimePredictor):
        #: engines must never share predictor state (online training and the
        #: feature cache are per engine).  None entries leave that member
        #: bit-identical to the predictor-less engine (pinned by tests).
        self.predictors = list(predictors) if predictors is not None \
            else [None] * len(clusters)
        if len(self.predictors) != len(clusters):
            raise ValueError(f"{len(clusters)} clusters but "
                             f"{len(self.predictors)} predictors")
        # scale-ups append to each member's spec.nodes: autoscaled members
        # get their own spec copy so caller-held fleet runs stay replayable
        clusters = [ClusterSpec(nodes=list(s.nodes), name=s.name)
                    if a is not None else s
                    for s, a in zip(clusters, self.autoscalers)]
        self.router = make_router(router, seed=router_seed)
        factory = prioritizer_factory or \
            (lambda i: PolicyPrioritizer(make_policy("fcfs")))
        self.engines: list[SchedulerEngine] = []
        self.telemetries: list[RollingTelemetry | None] = []
        for i, spec in enumerate(clusters):
            pri = factory(i)
            hooks: list = []
            tel = None
            if telemetry:
                tel = RollingTelemetry(window=telemetry_window,
                                       sample_interval=sample_interval)
                hooks.append(tel)
            if obs is not None:
                mobs = obs.member(i, name=spec.name or f"cluster{i}")
                hooks.extend(mobs.hooks())
            if self.predictors[i] is not None:
                hooks.append(self.predictors[i])
            if isinstance(pri, QuotaPrioritizer) and pri.incremental:
                pri.reset_usage()
                hooks.append(pri)
            # one MultiHooks per engine: duck-typed observers get the full
            # surface and a raising one cannot corrupt the member's window
            hooks = [MultiHooks(*hooks)] if hooks else []
            engine = SchedulerEngine(
                spec, pri, allocator=allocator, backfill=backfill,
                lookahead_k=lookahead_k, fault_model=fms[i],
                queue_window=queue_window, hooks=hooks, optimized=optimized,
                predictor=self.predictors[i])
            if isinstance(pri, QuotaPrioritizer):
                pri.engine = engine
            self.engines.append(engine)
            self.telemetries.append(tel)
        self.infos = [ClusterInfo.from_spec(i, spec)
                      for i, spec in enumerate(clusters)]
        self._views = [ClusterView(info, eng.snapshot())
                       for info, eng in zip(self.infos, self.engines)]
        self.routed = [0] * len(self.engines)
        self.routes: dict[int, int] = {}        # job_id -> cluster index
        #: cross-cluster migration policy (repro_torch.lifecycle.migration duck
        #: type: pick(fed, now) -> [MigrationEvent]); None = one-shot
        #: routing only, bit-identical to the pre-lifecycle federation
        self.migration = migration
        self.migrations: list = []              # executed MigrationEvents
        #: members currently blacked out by chaos (every node down): routing
        #: masks them with zero-capacity views — substitution, never list
        #: filtering, because routers index ``views[i]`` positionally
        self.offline: set[int] = set()
        self._blackout_downed: dict[int, list[int]] = {}
        #: jobs whose route found no *online* capable member, parked for
        #: retry with exponential backoff: (retry_at, seq, attempts, job)
        self._deferred: list[tuple[float, int, int, Job]] = []
        self._defer_seq = itertools.count()
        self.deferrals = 0                      # total defer decisions
        self.chaos_actions: list = []           # fleet ChaosActions applied
        #: opt-in threaded member stepping (see ``_step_members``): engines
        #: share no mutable state between window edges, so stepping them
        #: concurrently and summing in member order is decision-for-decision
        #: identical to the serial loop (pinned by differential tests).
        #: Forced serial under ``obs`` — member bundles count on the shared
        #: fleet registry, whose counters are not thread-safe.
        self.parallel = bool(parallel)
        self._pool: ThreadPoolExecutor | None = None

    # ------------------------------------------------------------- ingest ----
    def _routing_views(self) -> list[ClusterView]:
        """The views routers actually see: blacked-out members are masked
        by *substituting* a zero-capacity ``ClusterInfo`` (routers index
        ``views[i]`` positionally, so the list shape must never change) —
        the capable-cluster filter then degrades to the surviving set."""
        if not self.offline:
            return self._views
        views = list(self._views)
        for i in self.offline:
            v = views[i]
            views[i] = ClusterView(
                ClusterInfo(index=i, name=v.info.name, total_gpus=0,
                            total_by_type={}), v.snap)
        return views

    def _any_online_capable(self, job: Job) -> bool:
        return any(v.info.capacity_for(job.gpu_type) >= job.num_gpus
                   for i, v in enumerate(self._views)
                   if i not in self.offline)

    def _route_one(self, job: Job, *, force: bool = False) -> bool:
        """Route one job onto an engine; returns False when no online
        member could ever place it (caller defers).  ``force`` skips the
        capability check — the post-backoff escape hatch — but still
        routes on the online-masked views."""
        views = self._routing_views()
        if self.offline and not force and not self._any_online_capable(job):
            return False
        idx = self.router.route(job, views)
        if not 0 <= idx < len(self.engines):
            raise RuntimeError(
                f"router {self.router.name!r} returned cluster {idx} "
                f"for job {job.job_id} (fleet has {len(self.engines)})")
        self.engines[idx].submit((job,))
        self.routed[idx] += 1
        self.routes[job.job_id] = idx
        # refresh only the routed cluster's view: O(1), and the next
        # job's routing sees this one in the queue load
        self._views[idx] = ClusterView(self.infos[idx],
                                       self.engines[idx].snapshot())
        if self.obs is not None:
            self.obs.count("repro_fed_routed_total",
                           "jobs routed per member",
                           cluster=self.infos[idx].name or str(idx))
            if force:
                self.obs.count("repro_fed_forced_routes_total",
                               "post-backoff forced routes")
        return True

    def _defer(self, job: Job, now: float, attempts: int) -> None:
        delay = min(DEFER_BASE_S * 2 ** attempts, DEFER_MAX_S)
        heapq.heappush(self._deferred,
                       (now + delay, next(self._defer_seq), attempts + 1,
                        job))
        self.deferrals += 1
        if self.obs is not None:
            self.obs.count("repro_fed_deferrals_total",
                           "routes parked for backoff retry")

    def _retry_deferred(self, now: float, *, all_parked: bool = False) -> int:
        """Re-attempt parked routes due by ``now`` (``all_parked`` retries
        everything regardless of backoff — the member-restore path, where
        capacity just changed fundamentally); failures back off again, and
        a job out of attempts force-routes onto the best surviving member
        (or keeps waiting while the whole fleet is dark).  Returns how many
        jobs got routed."""
        due = []
        while self._deferred and (all_parked
                                  or self._deferred[0][0] <= now + 1e-9):
            due.append(heapq.heappop(self._deferred))
        routed = 0
        for _, _, attempts, job in due:
            force = (attempts >= DEFER_MAX_ATTEMPTS
                     and len(self.offline) < len(self.engines))
            if self._route_one(job, force=force):
                routed += 1
            else:
                self._defer(job, now, attempts)
        return routed

    def submit(self, jobs: Iterable[Job]) -> int:
        """Route each job to one engine at submit time (snapshot-only,
        O(N clusters) per job).  Jobs are ingested in submit-time order —
        the same normalization a single engine applies to a batch.  Jobs
        no *online* member could ever place (mid-blackout arrivals needing
        a dark member's SKU) are parked and retried with backoff."""
        batch = sorted(jobs, key=lambda j: j.submit_time)
        for job in batch:
            if not self._route_one(job):
                self._defer(job, job.submit_time, attempts=0)
        return len(batch)

    # ------------------------------------------------------------ queries ----
    @property
    def done(self) -> bool:
        return not self._deferred and all(e.done for e in self.engines)

    def next_event_time(self) -> float:
        nxt = min(e.next_event_time() for e in self.engines)
        if self._deferred:
            nxt = min(nxt, self._deferred[0][0])
        return nxt

    def snapshot(self) -> FleetSnapshot:
        snaps = tuple(e.snapshot() for e in self.engines)
        total_cap = sum(info.total_gpus for info in self.infos)
        util = 0.0
        if total_cap > 0:
            util = sum(s.utilization * info.total_gpus
                       for s, info in zip(snaps, self.infos)) / total_cap
        return FleetSnapshot(
            now=max(e.now for e in self.engines),
            clusters=snaps,
            routed=tuple(self.routed),
            submitted=sum(s.submitted for s in snaps),
            num_pending=sum(s.num_pending for s in snaps),
            num_running=sum(s.num_running for s in snaps),
            num_completed=sum(s.num_completed for s in snaps),
            free_gpus=sum(s.free_gpus for s in snaps),
            utilization=util,
            fairness=jain_index([s.utilization for s in snaps]),
        )

    # ----------------------------------------------------------- stepping ----
    def _step_members(self, until: float) -> int:
        """Step every member engine to ``until`` and return the summed
        event-batch count.  With ``parallel=True`` the per-member calls run
        in a lazily created thread pool: members are fully independent
        between window edges (routing, control, migration, and view
        refreshes all happen serially *after* this barrier), so the only
        shared state inside a step is each engine's own.  The pool's
        ``map`` preserves member order, and integer summation is
        order-insensitive anyway — outputs are bit-identical to the serial
        loop.  Wall-clock wins depend on members releasing the GIL (numpy
        percentile/sort paths do) and scale with member count, not jobs.
        On the card each member's predictor and actor launch their kernels
        from the member's worker thread, on the thread's current stream
        (the device's default stream); the kernels' ctypes calls release
        the GIL, and their launch counts are kept under a lock."""
        engines = self.engines
        if not self.parallel or len(engines) < 2 or self.obs is not None:
            return sum(e.step(until) for e in engines)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=min(len(engines), os.cpu_count() or 1),
                thread_name_prefix="fed-step")
        return sum(self._pool.map(lambda e: e.step(until), engines))

    def close(self) -> None:
        """Release the stepping thread pool (no-op for serial federations).
        Safe to call repeatedly; the pool is re-created on the next
        parallel step if the federation keeps running."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def step(self, until: float = math.inf) -> int:
        """Advance every engine in lockstep to ``until`` (one rescan
        window); returns total event batches processed.  Per-member
        autoscalers get their control tick at the window edge, *before* the
        view refresh — routers see scaled capacity through the refreshed
        snapshots immediately."""
        processed = self._step_members(until)
        if until != math.inf:
            self._control(until)
        self._refresh_views()
        if self._deferred and until != math.inf:
            if self._retry_deferred(until):
                self._refresh_views()
        if self.migration is not None and until != math.inf:
            if self._migrate(until):
                self._refresh_views()
        return processed

    def _migrate(self, now: float) -> int:
        """Execute the migration policy's moves for this window edge:
        drain from the source (``withdraw_pending`` → MIGRATING), resubmit
        on the destination with preserved remaining work
        (``admit_migrated``), and step the destination to the same edge so
        the arrival is ingested — and possibly scheduled — at the instant
        of the move.  Telemetry on both sides records the migration."""
        moves = self.migration.pick(self, now)
        for mv in moves:
            job, remaining = self.engines[mv.src].withdraw_pending(mv.job_id)
            dst = self.engines[mv.dst]
            if now > dst.now:
                dst.advance_to(now)       # arrivals land at the window edge
            dst.admit_migrated(job, remaining)
            dst.step(now)
            self.routed[mv.src] -= 1
            self.routed[mv.dst] += 1
            self.routes[mv.job_id] = mv.dst
            self.migrations.append(mv)
            for idx, kind in ((mv.src, "out"), (mv.dst, "in")):
                tel = self.telemetries[idx]
                note = getattr(tel, "note_migration", None)
                if note is not None:
                    note(kind)
            if self.obs is not None:
                self.obs.count(
                    "repro_fed_migrations_total",
                    "cross-cluster migrations executed",
                    src=self.infos[mv.src].name or str(mv.src),
                    dst=self.infos[mv.dst].name or str(mv.dst))
        return len(moves)

    def _control(self, now: float, stalled: bool = False) -> int:
        """Run every attached autoscaler's control tick; returns the number
        of scale events emitted fleet-wide."""
        acted = 0
        for i, (eng, scaler, tel) in enumerate(zip(self.engines,
                                                   self.autoscalers,
                                                   self.telemetries)):
            if scaler is None:
                continue
            if stalled and (eng.done or eng.next_event_time() != math.inf):
                continue   # only starved members get the override
            if self.obs is None:
                acted += len(scaler.control(eng, now, tel, stalled=stalled))
                continue
            t0 = time.perf_counter()
            events = scaler.control(eng, now, tel, stalled=stalled)
            self.obs.member(i).note_controller(
                "autoscaler", len(events), time.perf_counter() - t0, now)
            acted += len(events)
        return acted

    def control_stalled(self, now: float) -> int:
        """Stall override (see ``service.run_stream``): force a scale-up
        evaluation on members whose queues are starved with a dry event
        heap.  Refreshes views when anything changed."""
        acted = self._control(now, stalled=True)
        if acted:
            self._refresh_views()
        return acted

    def drain(self) -> int:
        """Process every queued event on every engine (batch semantics) —
        engines are independent after routing, so sequential drains equal
        lockstep stepping."""
        processed = sum(e.drain() for e in self.engines)
        self._refresh_views()
        return processed

    def run_until_complete(self) -> int:
        processed = 0
        while not self.done and self.next_event_time() != math.inf:
            processed += self.step(self.next_event_time())
        return processed

    def _refresh_views(self) -> None:
        for i, eng in enumerate(self.engines):
            snap = eng.snapshot()
            info = self.infos[i]
            # capacity staleness guard: the capable-cluster filter reads
            # static ClusterInfo, so autoscaled capacity must rebuild it —
            # a job sized for a scaled-up member would otherwise be deemed
            # unplaceable from pre-scaling totals (and vice versa)
            if (info.total_gpus != snap.total_gpus
                    or info.total_by_type != snap.total_gpus_by_type):
                info = ClusterInfo(index=i, name=info.name,
                                   total_gpus=snap.total_gpus,
                                   total_by_type=dict(snap.total_gpus_by_type))
                self.infos[i] = info
            self._views[i] = ClusterView(info, snap)

    # -------------------------------------------------------------- chaos ----
    def blackout_member(self, idx: int, at: float) -> list[int]:
        """Take every up node of member ``idx`` down at once (federation
        blackout): running gangs checkpoint-kill into the member's own
        queue, the member is marked offline, and routing degrades to the
        surviving capable set.  Returns the node ids actually downed (the
        set :meth:`restore_member` brings back — organically-failed nodes
        keep their own repair timelines)."""
        eng = self.engines[idx]
        if at > eng.now:
            eng.advance_to(at)
        cluster = eng.cluster
        downed: list[int] = []
        for node in range(len(cluster.total_gpus)):
            if not cluster.retired[node] and not cluster.node_down[node]:
                eng.force_fail(node)
                downed.append(node)
        self._blackout_downed[idx] = downed
        self.offline.add(idx)
        self._refresh_views()
        if self.obs is not None:
            self.obs.count("repro_fed_blackouts_total",
                           "member blackouts applied",
                           cluster=self.infos[idx].name or str(idx))
        return downed

    def restore_member(self, idx: int, at: float) -> list[int]:
        """Bring a blacked-out member back: recover exactly the nodes the
        blackout downed, reschedule its queue, and immediately retry every
        parked route (the member's capacity is visible again).  Returns
        the recovered node ids."""
        eng = self.engines[idx]
        if at > eng.now:
            eng.advance_to(at)
        downed = self._blackout_downed.pop(idx, [])
        for node in downed:
            eng.force_recover(node)
        eng.reschedule(at=at)
        self.offline.discard(idx)
        self._refresh_views()
        self._retry_deferred(at, all_parked=True)
        return downed

    def note_chaos(self, actions, now: float) -> None:
        """Record fleet chaos actions and forward each to its member's
        telemetry; refreshes views so the next routing decision sees the
        post-chaos capacity."""
        self.chaos_actions.extend(actions)
        for a in actions:
            if 0 <= a.cluster < len(self.telemetries):
                tel = self.telemetries[a.cluster]
                note = getattr(tel, "note_chaos_events", None)
                if note is not None:
                    note([a])
            if self.obs is not None:
                self.obs.count("repro_chaos_actions_total",
                               "fleet chaos actions applied", kind=a.kind)
        self._refresh_views()

    # ------------------------------------------------------------- result ----
    def finalize_telemetry(self) -> None:
        """Force an end-of-run sample on every cluster's telemetry."""
        for tel, eng in zip(self.telemetries, self.engines):
            if tel is not None:
                tel.final(eng)

    def result(self) -> FleetResult:
        per = [e.result() for e in self.engines]
        jobs = [j for e in self.engines for j in e.completed]
        jcts = np.array([j.jct for j in jobs]) if jobs else None
        waits = np.array([j.wait_time for j in jobs]) if jobs else None
        t0 = min((e.t0 for e in self.engines if e.t0 is not None),
                 default=0.0)
        t_end = max((j.finish_time for j in jobs), default=t0)
        makespan = t_end - t0
        cap_gpus = sum(info.total_gpus for info in self.infos)
        capacity = cap_gpus * max(makespan, 1e-9)
        used = sum(r.gpu_seconds_used for r in per)
        return FleetResult(
            per_cluster=per, routed=list(self.routed), jobs=jobs,
            makespan=makespan, gpu_seconds_used=used,
            utilization=used / capacity if capacity > 0 else 0.0,
            avg_jct=float(jcts.mean()) if jcts is not None else 0.0,
            avg_wait=float(waits.mean()) if waits is not None else 0.0,
            jct_p50=_pct(jcts, 50), jct_p99=_pct(jcts, 99),
            wait_p50=_pct(waits, 50), wait_p99=_pct(waits, 99),
            fairness=jain_index(
                [r.gpu_seconds_used / max(info.total_gpus, 1)
                 for r, info in zip(per, self.infos)]),
        )


# ----------------------------------------------------------------- drivers ----


@dataclasses.dataclass
class FleetStreamResult:
    """Outcome of replaying a fleet stream through the federation."""

    result: FleetResult
    snapshot: FleetSnapshot
    telemetries: list
    windows: int
    fed: FederatedScheduler
    obs: object | None = None


def run_fleet(
    run: FleetRun | str,
    num_jobs: int = 1000,
    seed: int = 0,
    *,
    router: Router | str = "jsq",
    rescan_interval: float = 60.0,
    allocator: str = "milp",
    backfill: bool = True,
    policy: str = "fcfs",
    prioritizer_factory: Callable[[int], Prioritizer] | None = None,
    queue_window: int | None = None,
    telemetry_window: float = 6 * 3600.0,
    sample_interval: float = 600.0,
    router_seed: int = 0,
    optimized: bool = True,
    autoscaler_factory: Callable | None = None,
    migration=None,
    chaos=None,
    obs=None,
    parallel: bool = False,
    predictor_factory: Callable | None = None,
) -> FleetStreamResult:
    """Replay a fleet scenario (or a prebuilt ``FleetRun``) through a fresh
    federation in lockstep rescan windows: each window's arrivals are routed
    as the window opens, then every engine steps to the window edge.  Empty
    multi-window gaps are hopped in one grid-aligned jump (same contract as
    ``service.run_stream``).  The fleet's tenant metadata (SLA users, VC
    quotas) wraps every cluster's prioritizer via ``wrap_tenancy``.

    ``autoscaler_factory(i, spec)`` builds member ``i``'s ``repro_torch.scale``
    controller (return ``None`` for fixed-capacity members); controllers
    tick at every lockstep window edge and routers see scaled capacity
    through the refreshed views.

    ``predictor_factory(i, spec)`` builds member ``i``'s
    ``repro_torch.predict.RuntimePredictor`` (return ``None`` for predictor-less
    members) — predictors train per member from that engine's completion
    hooks and must never be shared across members.

    ``migration`` attaches a ``repro_torch.lifecycle.migration`` policy: waiting
    jobs re-route between members at every window edge when fresh snapshots
    show a sufficiently better home (``migration=None`` keeps the one-shot
    routing, bit-identical to the pre-lifecycle federation).

    ``chaos`` attaches a ``repro_torch.chaos.FleetChaosInjector`` (ticking first
    at every window edge, like ``service.run_stream``): ``None`` wraps the
    fleet run's own ``ChaosSchedule`` if it declares one, ``False`` forces
    chaos off, anything else is used directly.

    ``obs`` attaches a fleet-level ``repro_torch.obs.Observability``: each member
    engine gets its own child tracer/metrics/audit hooks (distinct trace
    pids), control-plane ticks are timed, and the bundle is finalized
    before the result is returned.  ``obs=None`` keeps the run bit-identical
    to an unobserved fleet.

    ``parallel=True`` steps member engines through a thread pool inside
    every lockstep window (outputs pinned bit-identical to the serial
    path, see ``FederatedScheduler._step_members``); the pool is released
    before the result is returned."""
    if isinstance(run, str):
        run = get_fleet_scenario(run).build(num_jobs, seed)
    run_chaos = getattr(run, "chaos", None)
    if chaos is None and run_chaos is not None:
        from repro_torch.chaos import FleetChaosInjector
        chaos = FleetChaosInjector(run_chaos)
    elif chaos is False:
        chaos = None
    factory = prioritizer_factory or (
        lambda i: wrap_tenancy(PolicyPrioritizer(make_policy(policy)),
                               run.sla_users, run.vc_quotas))
    autoscalers = None
    if autoscaler_factory is not None:
        autoscalers = [autoscaler_factory(i, spec)
                       for i, spec in enumerate(run.clusters)]
    predictors = None
    if predictor_factory is not None:
        predictors = [predictor_factory(i, spec)
                      for i, spec in enumerate(run.clusters)]
    fed = FederatedScheduler(
        run.clusters, router, prioritizer_factory=factory,
        allocator=allocator, backfill=backfill,
        fault_models=run.fault_models, queue_window=queue_window,
        telemetry_window=telemetry_window, sample_interval=sample_interval,
        router_seed=router_seed, optimized=optimized,
        autoscalers=autoscalers, migration=migration, obs=obs,
        parallel=parallel, predictors=predictors)

    def _chaos_tick(now):
        if obs is None:
            return chaos.control(fed, now)
        t0_w = time.perf_counter()
        applied = chaos.control(fed, now)
        obs.note_controller("fleet-chaos", len(applied),
                            time.perf_counter() - t0_w, now)
        return applied

    jobs = sorted((j.clone_pending() for j in run.jobs),
                  key=lambda j: j.submit_time)
    iv = max(rescan_interval, 1e-6)
    t0 = jobs[0].submit_time if jobs else 0.0
    t = t0
    feed = 0
    windows = 0
    while True:
        hi = feed
        while hi < len(jobs) and jobs[hi].submit_time <= t + iv:
            hi += 1
        if hi > feed:
            fed.submit(jobs[feed:hi])
            feed = hi
        if feed >= len(jobs) and (fed.done
                                  or fed.next_event_time() == math.inf):
            if not fed.done and chaos is not None \
                    and chaos.next_time() < math.inf:
                # dry heaps with work still queued (or parked routes): only
                # a chaos event — e.g. the restore ending a blackout — can
                # unblock them; hop to its window edge and tick
                t = t0 + math.ceil((chaos.next_time() - t0) / iv) * iv
                fed.step(t)
                _chaos_tick(t)
                continue
            if fed.done or autoscalers is None:
                break
            # starved member(s) with dry heaps: only added capacity can
            # unblock them (same stall override as service.run_stream)
            t += iv
            if not fed.control_stalled(t) \
                    and fed.next_event_time() == math.inf:
                break
            continue
        nxt = fed.next_event_time()
        if feed < len(jobs):
            nxt = min(nxt, jobs[feed].submit_time)
        if chaos is not None:
            nxt = min(nxt, chaos.next_time())
        if nxt > t + iv:
            t = t0 + math.floor((nxt - t0) / iv) * iv
            continue
        if obs is not None:
            t_step = time.perf_counter()
            fed.step(t + iv)
            obs.note_window(t, time.perf_counter() - t_step, 0)
        else:
            fed.step(t + iv)
        t += iv
        windows += 1
        if chaos is not None:
            _chaos_tick(t)
    fed.finalize_telemetry()
    fed.close()
    if obs is not None:
        obs.finalize_fleet(fed)
    return FleetStreamResult(result=fed.result(), snapshot=fed.snapshot(),
                             telemetries=fed.telemetries, windows=windows,
                             fed=fed, obs=obs)

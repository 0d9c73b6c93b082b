"""Resumable streaming scheduler engine (the paper's continuous service mode).

The seed code's event loop lived inside ``Simulator.run_batch`` and reset an
idle cluster per 256-job batch.  The paper's RLTune, however, runs as a
*continuous* Slurm-integrated service (Sec. 3.1.2: a 1-minute rescan loop over
a live queue), so this module hoists the loop into a long-lived
``SchedulerEngine`` that owns the event heap, pending/running state, fault
injection, EASY backfilling, and allocation:

- ``submit(jobs)``  — stream more jobs in at any time; the cluster is never
  reset between submissions.
- ``step(until)``   — process events up to a time bound and return; resumable.
- ``drain()``       — process every queued event (batch semantics).
- ``snapshot()``    — cheap O(1) view of clock/queue/utilization for drivers.

Two ``step()`` calls are exactly equivalent to one ``drain()`` over the same
span: the clock only advances by popping events, and scheduling decisions only
happen at event instants, so pausing between events is unobservable.
``Simulator.run_batch`` is now a thin wrapper over this engine and is
bit-identical to the seed implementation on fixed seeds.

Observers can attach hook objects (see ``EngineHooks``) to receive job
start/finish/requeue callbacks and per-event-batch ticks — this is how
``repro_torch.sched.telemetry`` builds rolling-window metrics without perturbing
the schedule.

Decision-loop complexity
------------------------
The default (``optimized=True``) hot path keeps per-event cost near
O(log n) amortized in the pending-queue depth n:

- ``pending`` is an **indexed queue**: a list maintained sorted by
  ``(submit_time, job_id)`` via ``bisect`` — insertion is O(log n)
  comparisons (plus a C-level memmove), window extraction is an O(window)
  slice, and removal locates the job by bisection instead of a linear scan.
  The naive path re-sorted the whole list and ``.remove()``'d per decision.
- The cluster carries a **version counter** (see ``repro_torch.core.cluster``)
  bumped on allocate/release/fail_node/recover_node; per-SKU free-GPU
  tallies and per-job-shape ``can_schedule_now`` / ``candidate_ways``
  feasibility are memoized per version, so saturated clusters and repeated
  backfill scans answer repeated placement questions from a dict.
- ``_earliest_start`` reuses one scratch ``ClusterState`` instead of
  allocating four numpy arrays per backfill reservation, and walks a
  **finish-time-ordered index** (sorted ``(finish, job_id)`` pairs kept
  alongside ``running``) instead of re-sorting the running set per call.
- ``PolicyPrioritizer`` scores the window with one ``score_batch`` call
  (numpy, bit-identical to the scalar loop) instead of a Python loop.

``optimized=False`` retains the seed's naive loop — re-sort + linear scans,
no caches, scalar scoring — as the reference for differential equivalence
tests; both paths must produce bit-identical schedules.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
import math
import pickle
import time
from collections import deque
from typing import Iterable

import numpy as np

from repro_torch.core import spans
from repro_torch.core.cluster import ClusterState, Placement
from repro_torch.core.faults import FaultInjector, FaultModel
from repro_torch.core.metrics import BatchResult
from repro_torch.core.milp import choose_allocation
from repro_torch.core.prioritizer import (  # noqa: F401  (PolicyPrioritizer
    PolicyPrioritizer,                # re-exported via repro_torch.sched)
    Prioritizer, ShapeTable, WindowFields)
from repro_torch.core.types import ClusterSpec, Job, JobState
from repro_torch.lifecycle.machine import transition

#: Pending-queue window handed to the prioritizer each decision (the seed
#: hard-coded ``10 * 256``; now a configurable engine parameter).
DEFAULT_QUEUE_WINDOW = 10 * 256


def _pending_key(job: Job) -> tuple[float, int]:
    return (job.submit_time, job.job_id)


class _PendingFieldIndex:
    """Contiguous field arrays mirroring the sorted pending queue.

    Inserts/removals memmove the suffix (C-speed, amortized cheap next to
    the O(window) Python work they replace); the ranking window is then a
    free O(1) slice view per field, so batch scoring never re-gathers job
    attributes.  Integer-valued fields (``num_gpus``, ``user``, ``vc``,
    ``job_id``) are stored as float64 — exact for any realistic value
    (< 2**53).

    ``_sid`` carries a small-int **shape id** per job (``shapes`` interns
    the ``_job_shape`` key): placement feasibility is a pure function of
    (shape, cluster version), so the deep-backfill scan can skip a
    shape it already saw fail at the current version without touching
    the job object at all, and the feature build queries the cluster
    once per distinct shape in the window."""

    __slots__ = ("n", "_cap", "_st", "_rt", "_est", "_gpus", "_user", "_vc",
                 "_jid", "_sid", "shapes")

    def __init__(self, cap: int = 256):
        self.n = 0
        self._cap = cap
        self._st = np.empty(cap, dtype=np.float64)
        self._rt = np.empty(cap, dtype=np.float64)
        self._est = np.empty(cap, dtype=np.float64)
        self._gpus = np.empty(cap, dtype=np.float64)
        self._user = np.empty(cap, dtype=np.float64)
        self._vc = np.empty(cap, dtype=np.float64)
        self._jid = np.empty(cap, dtype=np.float64)
        self._sid = np.empty(cap, dtype=np.intp)
        self.shapes = ShapeTable()

    def _arrays(self):
        return (self._st, self._rt, self._est, self._gpus, self._user,
                self._vc, self._jid, self._sid)

    def insert(self, idx: int, job: Job) -> None:
        n = self.n
        if n == self._cap:
            self._cap *= 2
            grown = []
            for a in self._arrays():
                g = np.empty(self._cap, dtype=a.dtype)
                g[:n] = a[:n]
                grown.append(g)
            (self._st, self._rt, self._est, self._gpus, self._user,
             self._vc, self._jid, self._sid) = grown
        for a, v in zip(self._arrays(),
                        (job.submit_time, job.runtime, job.est_runtime,
                         job.num_gpus, job.user, job.vc, job.job_id,
                         self.shapes.intern(job))):
            a[idx + 1:n + 1] = a[idx:n]
            a[idx] = v
        self.n = n + 1

    def remove(self, idx: int) -> None:
        n = self.n
        for a in self._arrays():
            a[idx:n - 1] = a[idx + 1:n]
        self.n = n - 1

    def window(self, w: int) -> WindowFields:
        w = min(w, self.n)
        return WindowFields(self._st[:w], self._rt[:w], self._est[:w],
                            self._gpus[:w], self._user[:w], self._vc[:w],
                            self._jid[:w], self._sid[:w], self.shapes.shapes)


class EngineHooks:
    """Observer interface for engine events.  All methods are optional
    no-ops; subclass and override what you need.  Hooks must never mutate
    engine state — they exist for telemetry/logging only."""

    def on_submit(self, job: Job, now: float) -> None: ...
    def on_start(self, job: Job, now: float) -> None: ...
    def on_finish(self, job: Job, now: float) -> None: ...
    def on_requeue(self, job: Job, now: float) -> None: ...
    def on_tick(self, now: float, engine: "SchedulerEngine") -> None: ...

    def on_preempt(self, job: Job, now: float, penalty_s: float) -> None:
        """A running job was checkpoint-evicted by the lifecycle layer
        (preempt or elastic resize).  ``penalty_s`` is the resume penalty
        charged, in work-seconds.  Fires *before* the matching
        ``on_requeue``; fault kills do NOT fire this."""
        ...

    def on_resume(self, job: Job, now: float) -> None:
        """A previously preempted/paused/migrated job restarted from its
        checkpoint.  Fires right after the matching ``on_start``."""
        ...

    def on_decision(self, jobs: list[Job], order: list[int], now: float,
                    engine: "SchedulerEngine") -> None:
        """One prioritizer decision: ``jobs`` is the ranking window handed
        to the prioritizer, ``order`` its returned permutation (index 0 =
        scheduled first).  Fired on both engine paths right after ranking —
        this is how the streaming RL episode cutter (``repro_torch.rl``) aligns
        rewards with recorded policy steps.  Observational only."""
        ...


#: every hook-surface method a ``MultiHooks`` fans out, including the
#: gated observability stream (``on_alloc`` / ``on_decision_audit`` /
#: ``on_window_blocked``) that only fires when some attached hook
#: actually defines it — see ``SchedulerEngine._rebuild_hook_dispatch``.
HOOK_METHODS = (
    "on_submit", "on_start", "on_finish", "on_requeue", "on_tick",
    "on_preempt", "on_resume", "on_decision",
    "on_alloc", "on_decision_audit", "on_window_blocked",
)


def _hook_defines(hook, name: str) -> bool:
    """Does ``hook`` carry a real implementation of ``name``?  Inherited
    ``EngineHooks`` no-ops don't count; duck-typed partial observers count
    exactly the methods they define; nested ``MultiHooks`` answer for
    their children via ``wants``."""
    wants = getattr(hook, "wants", None)
    if wants is not None:
        return bool(wants(name))
    fn = getattr(hook, name, None)
    if fn is None or not callable(fn):
        return False
    cls_fn = getattr(type(hook), name, None)
    return cls_fn is not getattr(EngineHooks, name, None) or cls_fn is None


class MultiHooks(EngineHooks):
    """Fan one engine hook stream out to many observers.

    Two jobs beyond simple iteration:

    - **Full-surface forwarding for duck-typed observers**: each child
      receives exactly the events it defines (inherited ``EngineHooks``
      no-ops are skipped, partial hook objects work), including the
      getattr-dispatched lifecycle events (``on_preempt`` /
      ``on_resume`` / ``on_decision``) and the gated observability stream
      — a user hook attached through ``service.run_stream`` loses nothing.
    - **Exception isolation**: a raising observer must never corrupt the
      schedule mid-window.  Exceptions are caught per child per event,
      recorded in ``errors`` / ``error_counts``, and dispatch continues
      with the remaining children.  Engine state is already consistent at
      every hook call site, so the schedule is unaffected (pinned by
      ``tests/test_obs.py``).
    """

    MAX_RECORDED_ERRORS = 100

    def __init__(self, *children):
        self.children: list = [c for c in children if c is not None]
        self.errors: list[tuple[str, object, Exception]] = []
        self.error_counts: dict[str, int] = {}
        self._rebuild()

    def _rebuild(self) -> None:
        self._dispatch = {
            name: [getattr(c, name) for c in self.children
                   if _hook_defines(c, name)]
            for name in HOOK_METHODS
        }

    def add(self, child) -> None:
        if child is not None:
            self.children.append(child)
            self._rebuild()

    def wants(self, name: str) -> bool:
        return bool(self._dispatch.get(name))

    def _fan(self, name: str, args: tuple) -> None:
        for fn in self._dispatch[name]:
            try:
                fn(*args)
            except Exception as exc:
                key = f"{name}:{type(exc).__name__}"
                self.error_counts[key] = self.error_counts.get(key, 0) + 1
                if len(self.errors) < self.MAX_RECORDED_ERRORS:
                    self.errors.append((name, getattr(fn, "__self__", fn),
                                        exc))

    # -- full EngineHooks surface, each forwarding to defining children ----
    def on_submit(self, job, now):
        self._fan("on_submit", (job, now))

    def on_start(self, job, now):
        self._fan("on_start", (job, now))

    def on_finish(self, job, now):
        self._fan("on_finish", (job, now))

    def on_requeue(self, job, now):
        self._fan("on_requeue", (job, now))

    def on_tick(self, now, engine):
        self._fan("on_tick", (now, engine))

    def on_preempt(self, job, now, penalty_s):
        self._fan("on_preempt", (job, now, penalty_s))

    def on_resume(self, job, now):
        self._fan("on_resume", (job, now))

    def on_decision(self, jobs, order, now, engine):
        self._fan("on_decision", (jobs, order, now, engine))

    # -- gated observability stream (repro_torch.obs) ----------------------------
    def on_alloc(self, job, placement, now, wall_s, path):
        self._fan("on_alloc", (job, placement, now, wall_s, path))

    def on_decision_audit(self, rec):
        self._fan("on_decision_audit", (rec,))

    def on_window_blocked(self, now, queued):
        self._fan("on_window_blocked", (now, queued))


@dataclasses.dataclass(frozen=True)
class EngineSnapshot:
    """O(1) view of engine state for drivers, dashboards, and federation
    routers.

    All capacity-derived fields count **up nodes only** and are guarded
    against zero-GPU / empty-cluster division: a cluster whose nodes have
    all failed reads ``free_gpus == 0`` and finite ``utilization`` /
    ``fragmentation`` (0.0), never NaN — degenerate fleet members must not
    poison snapshot-driven routing.  ``free_gpus_by_type`` is the per-SKU
    free-GPU tally on up nodes (the signal SKU-affinity routing needs).

    ``total_gpus`` / ``total_gpus_by_type`` are the *provisioned* totals
    (non-retired nodes, cordoned/draining included) — they move when the
    autoscaling layer adds or removes capacity, and federation routers
    rebuild their static ``ClusterInfo`` from them so the capable-cluster
    filter can never run on pre-scaling capacity.
    """

    now: float
    submitted: int
    num_pending: int
    num_running: int
    num_completed: int
    free_gpus: int
    utilization: float
    fragmentation: float
    decisions: int
    milp_calls: int
    backfills: int
    restarts: int
    free_gpus_by_type: dict = dataclasses.field(default_factory=dict)
    total_gpus: int = 0
    total_gpus_by_type: dict = dataclasses.field(default_factory=dict)
    cordoned: int = 0
    preemptions: int = 0
    paused: int = 0
    resume_penalty_gpu_s: float = 0.0
    nodes_down: int = 0
    nodes_total: int = 0
    reclaimed_jobs: int = 0
    milp_fallbacks: int = 0
    degraded_windows: int = 0
    degraded_s: float = 0.0
    bf_reservations: int = 0
    bf_overruns: int = 0

    @property
    def in_flight(self) -> int:
        return self.num_pending + self.num_running

    @property
    def bf_overrun_ratio(self) -> float:
        """Fraction of predictor-gated backfill reservations that were
        blown (job preempted past its deadline); 0.0 when prediction-
        assisted backfill never committed a reservation."""
        return min(self.bf_overruns / max(self.bf_reservations, 1), 1.0)

    @property
    def down_ratio(self) -> float:
        """Fraction of provisioned (non-retired) nodes currently failed;
        0.0 for an empty cluster (never a ZeroDivisionError)."""
        return self.nodes_down / max(self.nodes_total, 1)

    @property
    def milp_fallback_ratio(self) -> float:
        """Fraction of solver-eligible allocations that took the degraded
        greedy path; 0.0 when the solver was never eligible."""
        return self.milp_fallbacks / max(self.milp_calls
                                         + self.milp_fallbacks, 1)


class SchedulerEngine:
    """Incremental discrete-event scheduler for one cluster.

    Jobs stream in via :meth:`submit`; the simulation clock advances only
    inside :meth:`step` / :meth:`drain` by consuming the event heap.  State
    (cluster allocation, pending queue, running set, fault timeline) persists
    across calls, so a driver can interleave submission and stepping
    indefinitely without restarting the cluster.

    ``optimized`` selects the indexed-queue + feasibility-cache hot path
    (default); ``optimized=False`` runs the retained naive reference loop.
    Both produce bit-identical schedules.
    """

    def __init__(
        self,
        spec: ClusterSpec,
        prioritizer: Prioritizer,
        *,
        allocator: str = "milp",          # "milp" | "pack" | "spread" | "greedy"
        backfill: bool = True,
        lookahead_k: int = 8,
        fault_model: FaultModel | None = None,
        straggler_migration: bool = True,
        max_sim_time: float = 90 * 86400.0,
        queue_window: int | None = None,   # None = DEFAULT_QUEUE_WINDOW
        hooks: Iterable[EngineHooks] = (),
        optimized: bool = True,
        degradation=None,                  # duck-typed DegradationPolicy
        completed_summary: bool = False,
        completed_keep: int = 1024,
        deep_lookahead_k: int | None = None,
        deep_queue_threshold: int = 4096,
        predictor=None,                    # duck-typed RuntimePredictor
    ):
        self.spec = spec
        self.prioritizer = prioritizer
        self.allocator = allocator
        self.backfill = backfill
        self.lookahead_k = lookahead_k
        self.fault_model = fault_model
        self.straggler_migration = straggler_migration
        self.max_sim_time = max_sim_time
        self.queue_window = (queue_window if queue_window is not None
                             else DEFAULT_QUEUE_WINDOW)
        self.hooks: list[EngineHooks] = list(hooks)
        self.optimized = optimized
        #: control-plane degradation ladder (see ``repro_torch.chaos``); the
        #: engine duck-types the policy so ``repro_torch.sched`` never imports
        #: ``repro_torch.chaos``.  ``None`` (the default) never reads the
        #: wall clock — pinned bit-identical to the pre-chaos engine.
        self.degradation = degradation
        #: online runtime predictor (see ``repro_torch.predict``), duck-typed so
        #: ``repro_torch.sched`` never imports ``repro_torch.predict``.  ``None`` — and
        #: an attached predictor in shadow mode (``assist=False``: trains
        #: from the hook stream, never consulted) — are pinned bit-identical
        #: to the pre-prediction engine.  With assist on, backfill gates on
        #: predicted p90 reservations, MILP lookahead gets predicted p50
        #: durations, and blown reservations preempt at the overrun cost.
        self.predictor = predictor
        if predictor is not None:
            bind = getattr(predictor, "bind", None)
            if bind is not None:
                bind(self)

        self.cluster = ClusterState(spec, cache=optimized)
        self._seq = itertools.count()
        self._events: list[tuple[float, int, str, object]] = []
        #: pending queue; in optimized mode kept sorted by (submit_time,
        #: job_id) at all times (indexed queue), in naive mode re-sorted
        #: inside ``_try_schedule`` exactly like the seed loop
        self.pending: list[Job] = []
        # job_id -> [job, placement, start, finish, speed]
        self.running: dict[int, list] = {}
        #: finish-time-ordered index over `running`: sorted (finish, job_id)
        #: pairs maintained on start/finish/kill/rescale so backfill
        #: reservations (`_earliest_start`) iterate it directly instead of
        #: re-sorting the running set per call (optimized mode only)
        self._finish_index: list[tuple[float, int]] = []
        self.remaining: dict[int, float] = {}
        self.completed: list[Job] = []
        #: opt-in compact completion accounting for million-job streams:
        #: with ``completed_summary=True`` finished Job objects are NOT
        #: retained — ``completed`` stays empty, a bounded tuple ring
        #: (``completed_ring``) keeps the most recent ``completed_keep``
        #: finishes as ``(job_id, submit, start, finish, num_gpus, vc)``
        #: tuples, and running aggregates (``completed_stats()``) replace
        #: the per-job list.  Default (False) is pinned bit-identical.
        self.completed_summary = completed_summary
        self.completed_count = 0
        self.completed_ring = deque(maxlen=max(int(completed_keep), 1))
        self._sum_jct = 0.0
        self._sum_wait = 0.0
        self._max_finish = -math.inf
        #: opt-in deep-queue lookahead shrink: when the pending queue is
        #: deeper than ``deep_queue_threshold``, MILP lookahead is cut to
        #: ``deep_lookahead_k`` jobs (a smaller model per solve).  The
        #: default (None) never changes the lookahead — pinned.
        self.deep_lookahead_k = deep_lookahead_k
        self.deep_queue_threshold = deep_queue_threshold
        self.gpu_seconds = 0.0
        self.decisions = 0
        self.milp_calls = 0
        self.backfills = 0
        #: prediction-assisted backfill accounting (inert while the
        #: predictor is off): reservations committed under a predicted-p90
        #: gate, reservations blown (job preempted past its deadline), the
        #: per-job deadlines themselves, and jobs that already blew one
        #: reservation (barred from further predictor-gated backfills so an
        #: unlearnable job cannot thrash preempt/backfill forever)
        self.bf_reservations = 0
        self.bf_overruns = 0
        self._bf_deadlines: dict[int, float] = {}
        self._bf_overrun_jobs: set[int] = set()
        self.restarts = 0
        self.preemptions = 0
        self.resume_penalty_gpu_s = 0.0
        #: chaos / degradation counters (surface in snapshot + telemetry)
        self.reclaimed_jobs = 0          # jobs preempted by spot reclamation
        self.milp_fallbacks = 0          # solver-eligible allocs gone greedy
        self.degraded_windows = 0        # rescan windows forced to FCFS
        self.degraded_s = 0.0            # sim-seconds spent FCFS-degraded
        # degradation-ladder state (inert while self.degradation is None)
        self._deg_fallback_open = 0      # greedy decisions left on breaker
        self._deg_slow_streak = 0        # consecutive over-budget solves
        self._deg_window_start: float | None = None
        self._deg_window_wall = 0.0      # wall-s accrued in current bucket
        self._deg_fcfs_until: float | None = None
        #: jobs checkpoint-suspended via pause_job: job_id -> Job (hold no
        #: GPUs, sit outside the pending queue until resume / migration)
        self.paused: dict[int, Job] = {}
        #: job_ids whose next start is a checkpoint *resume* (preempted,
        #: paused, or admitted mid-flight) — drives the on_resume hook;
        #: fault-kill requeues intentionally never enter this set
        self._resume_pending: set[int] = set()
        self.slow_nodes: dict[int, float] = {}
        self.now = 0.0
        self.t0: float | None = None
        self.submitted = 0
        self._injector: FaultInjector | None = None
        self._scratch: ClusterState | None = None   # _earliest_start reuse
        self._pindex = _PendingFieldIndex() if optimized else None
        self._rank_window = getattr(prioritizer, "rank_window", None)
        #: version-keyed negative placement memo for the backfill scan:
        #: shape ids proven unplaceable at ``_neg_ver`` (== cluster.version).
        #: Feasibility is a pure function of (shape, version) — see
        #: ``repro_torch.core.cluster.candidate_ways`` — so a hit is exact, and
        #: any allocation bumps the version, auto-invalidating the set.
        #: Derived cache: rebuilt empty on load_state (always safe).
        self._neg_shapes: set[int] = set()
        self._neg_ver = -1
        # runaway guard: budget grows with submissions / injected faults,
        # matching the seed's `200 * len(jobs) + 10_000 + 4 * faults` bound
        self._guard = 0
        self._guard_budget = 10_000
        self._rebuild_hook_dispatch()
        spans.follow_profiler()

    def _rebuild_hook_dispatch(self) -> None:
        """Precompute which attached hooks define the gated observability
        stream (``on_alloc`` / ``on_decision_audit``).  Derived from
        ``hooks``, never pickled — rebuilt here and in ``load_state``.
        With no such observer both lists are empty and the hot paths take
        their pre-obs branches untouched (pinned bit-identical)."""
        self._alloc_obs = [h for h in self.hooks
                           if _hook_defines(h, "on_alloc")]
        self._audit_obs = [h for h in self.hooks
                           if _hook_defines(h, "on_decision_audit")]

    def add_hook(self, hook: EngineHooks) -> None:
        """Attach an observer after construction (keeps the gated-dispatch
        lists in sync — prefer this over mutating ``hooks`` directly)."""
        self.hooks.append(hook)
        self._rebuild_hook_dispatch()

    # ------------------------------------------------------------- ingest ----
    def submit(self, jobs: Iterable[Job]) -> int:
        """Register jobs for arrival at their ``submit_time``.  May be called
        any number of times; returns how many jobs were accepted."""
        batch = sorted(jobs, key=lambda j: j.submit_time)
        if not batch:
            return 0
        if self.t0 is None:
            self.t0 = batch[0].submit_time
            # never rewind: a virgin engine may already sit past t0 (e.g. a
            # blacked-out federation member whose first route arrives after
            # the restore advanced its clock)
            self.now = max(self.now, self.t0)
        for j in batch:
            self.remaining[j.job_id] = j.runtime
            # a job submitted behind the clock is ingested *now*: the event
            # time is clamped so the clock never runs backwards (job.submit_time
            # itself is kept — it still anchors wait/JCT accounting)
            heapq.heappush(self._events,
                           (max(j.submit_time, self.now),
                            next(self._seq), "arrival", j))
            for h in self.hooks:
                h.on_submit(j, self.now)
        self.submitted += len(batch)
        self._guard_budget += 200 * len(batch)
        if self.fault_model is not None and self._injector is None:
            horizon = self.t0 + self.max_sim_time
            self._injector = FaultInjector(self.fault_model,
                                           len(self.spec.nodes), horizon)
            # fault marker events so the clock advances to fault instants
            for (ft, kind, node) in list(self._injector.events):
                heapq.heappush(self._events,
                               (ft, next(self._seq), "fault", node))
            self._guard_budget += 4 * len(self._injector.events)
        return len(batch)

    # ------------------------------------------------------------ queries ----
    @property
    def done(self) -> bool:
        """All submitted jobs have completed.  ``completed_count`` equals
        ``len(self.completed)`` whenever ``completed_summary`` is off, and
        keeps counting when the compact mode drops the Job objects."""
        return self.completed_count >= self.submitted

    def next_event_time(self) -> float:
        return self._events[0][0] if self._events else math.inf

    def snapshot(self) -> EngineSnapshot:
        free_up, free_by_type = self.cluster.free_gpu_tallies()
        prov, prov_by_type = self.cluster.provisioned_gpu_totals()
        return EngineSnapshot(
            now=self.now, submitted=self.submitted,
            num_pending=len(self.pending), num_running=len(self.running),
            num_completed=self.completed_count,
            free_gpus=free_up,
            utilization=self.cluster.utilization(up_only=True),
            fragmentation=self.cluster.fragmentation(up_only=True),
            decisions=self.decisions, milp_calls=self.milp_calls,
            backfills=self.backfills, restarts=self.restarts,
            free_gpus_by_type=dict(free_by_type),
            total_gpus=prov, total_gpus_by_type=dict(prov_by_type),
            cordoned=int(self.cluster.cordoned.sum()),
            preemptions=self.preemptions, paused=len(self.paused),
            resume_penalty_gpu_s=self.resume_penalty_gpu_s,
            nodes_down=int((self.cluster.node_down
                            & ~self.cluster.retired).sum()),
            nodes_total=int((~self.cluster.retired).sum()),
            reclaimed_jobs=self.reclaimed_jobs,
            milp_fallbacks=self.milp_fallbacks,
            degraded_windows=self.degraded_windows,
            degraded_s=self.degraded_s,
            bf_reservations=self.bf_reservations,
            bf_overruns=self.bf_overruns,
        )

    # ------------------------------------------------------ pending queue ----
    def _push_pending(self, job: Job) -> None:
        if self.optimized:
            idx = bisect.bisect_right(self.pending, _pending_key(job),
                                      key=_pending_key)
            self.pending.insert(idx, job)
            self._pindex.insert(idx, job)
        else:
            self.pending.append(job)

    def _remove_pending(self, job: Job) -> None:
        if self.optimized:
            idx = bisect.bisect_left(self.pending, _pending_key(job),
                                     key=_pending_key)
            # job_ids are unique, so bisection lands exactly on `job`
            if not (idx < len(self.pending) and self.pending[idx] is job):
                idx = self.pending.index(job)   # defensive: keep index in sync
            del self.pending[idx]
            self._pindex.remove(idx)
            return
        self.pending.remove(job)

    # ------------------------------------------------- finish-time index ----
    def _finish_index_remove(self, finish: float, jid: int) -> None:
        key = (finish, jid)
        idx = bisect.bisect_left(self._finish_index, key)
        if not (idx < len(self._finish_index)
                and self._finish_index[idx] == key):
            idx = self._finish_index.index(key)   # defensive: resync
        del self._finish_index[idx]

    # ------------------------------------------------------------ stepping ----
    def step(self, until: float = math.inf, max_events: int | None = None) -> int:
        """Process event batches with timestamp <= ``until``; returns how many
        were processed.  The clock never advances past the last processed
        event, so interleaving ``step`` calls is equivalent to one ``drain``."""
        processed = 0
        sp = spans.ACTIVE
        if sp is not None and sp.follows_profiler:
            # a recorder the profiler switched on goes off with it
            sp = spans.follow_profiler()
        depth = sp.depth if sp is not None else 0
        try:
            while self._events and self._events[0][0] <= until:
                if max_events is not None and processed >= max_events:
                    break
                self._guard += 1
                if self._guard >= self._guard_budget:
                    # a real error, not an assert: must survive `python -O`
                    raise RuntimeError(
                        f"scheduler engine stuck: processed {self._guard} "
                        f"event batches against a budget of "
                        f"{self._guard_budget} ({self.submitted} submitted, "
                        f"{self.completed_count} completed)")
                if sp is not None:
                    sp.open("rltune.step")
                    sp.open("rltune.events")
                now, _, kind, payload = heapq.heappop(self._events)
                self.now = now
                # fold in all events at the same instant
                batch_evts = [(kind, payload)]
                while self._events and self._events[0][0] <= now + 1e-9:
                    _, _, k2, p2 = heapq.heappop(self._events)
                    batch_evts.append((k2, p2))
                self._handle_faults()
                for k, p in batch_evts:
                    if k == "arrival":
                        self._push_pending(p)
                    elif k == "finish":
                        jid = p
                        rec = self.running.get(jid)
                        if rec is not None and abs(rec[3] - now) < 1e-6:
                            self._finish_job(jid)
                if sp is not None:
                    sp.close()
                    sp.open("rltune.schedule")
                self._try_schedule()
                if sp is not None:
                    sp.close()
                    sp.open("rltune.hooks")
                for h in self.hooks:
                    h.on_tick(self.now, self)
                if sp is not None:
                    sp.close()
                    sp.close()
                processed += 1
        finally:
            if sp is not None:
                # spans a raising pass left open
                sp.unwind(depth)
        return processed

    def drain(self) -> int:
        """Process every queued event (batch-mode semantics)."""
        return self.step(math.inf)

    def run_until_complete(self) -> int:
        """Step until all submitted jobs finished or the heap runs dry."""
        processed = 0
        while not self.done and self._events:
            processed += self.step(self.next_event_time())
        return processed

    def advance_to(self, at: float) -> None:
        """Advance the clock to ``at`` *without* a scheduling pass — the
        lifecycle controller's window-edge alignment.  ``step(until)`` only
        moves the clock to the last processed event, so a controller acting
        at the window edge would otherwise compute elapsed work against a
        stale instant.  Unlike :meth:`reschedule` this runs no decision and
        fires no hooks: a controller that then takes no action is
        unobservable (pinned bit-identical, counters included)."""
        if at > self.now:
            if self._events and self._events[0][0] < at:
                raise RuntimeError(
                    f"advance_to t={at} would skip a queued event at "
                    f"t={self._events[0][0]}; step() there first")
            self.now = at
            self._handle_faults()

    def reschedule(self, at: float | None = None) -> None:
        """Run one scheduling pass, outside any event instant.  Capacity
        mutations (autoscaler ``add_node`` / ``remove_node``) are not
        simulation events: without a kick, a scale-up that makes a starved
        queue feasible again would sit idle until the next unrelated event.

        ``at`` advances the clock to the mutation instant (a rescan-window
        edge, by the service-loop contract always >= every already-processed
        event and <= every queued one) so jobs started by the pass don't
        time-travel back to the last event.  Fires ``on_tick`` so telemetry
        integrates the capacity change at the right instant."""
        if at is not None and at > self.now:
            if self._events and self._events[0][0] < at:
                raise RuntimeError(
                    f"reschedule at t={at} would skip a queued event at "
                    f"t={self._events[0][0]}; step() there first")
            self.now = at
        # nodes added since the fault timeline was drawn (autoscaler
        # scale-ups) get their own deterministic timeline, seeded by
        # (model.seed, node_id), starting their MTBF clock *now* — added
        # capacity is no longer fault-immune
        if self._injector is not None:
            n_nodes = len(self.cluster.total_gpus)
            first_new = self._injector.num_nodes
            for nid in range(first_new, n_nodes):
                events = self._injector.extend_node(nid, self.now)
                for (ft, _kind, node) in events:
                    heapq.heappush(self._events,
                                   (ft, next(self._seq), "fault", node))
                self._guard_budget += 4 * len(events)
        # apply fail/recover/straggler transitions due by the (possibly
        # advanced) clock before scheduling, exactly like step() does — in
        # the service-loop contract this is a no-op (fault markers are heap
        # events, already processed up to the window edge), but a caller
        # rescheduling past a due transition must not place onto it
        self._handle_faults()
        self._try_schedule()
        for h in self.hooks:
            h.on_tick(self.now, self)

    # ------------------------------------------------------------- result ----
    def result(self) -> BatchResult:
        """Aggregate metrics over everything completed so far.  In
        ``completed_summary`` mode ``jobs`` is empty (the engine dropped
        the Job objects); the makespan comes from the tracked max finish
        and per-job statistics from :meth:`completed_stats`."""
        t0 = self.t0 if self.t0 is not None else 0.0
        if self.completed_summary:
            top = self._max_finish if self.completed_count else self.now
            makespan = top - t0
        else:
            makespan = max((j.finish_time for j in self.completed),
                           default=self.now) - t0
        capacity = self.spec.total_gpus * max(makespan, 1e-9)
        return BatchResult(
            jobs=self.completed, makespan=makespan,
            gpu_seconds_used=self.gpu_seconds,
            gpu_seconds_capacity=capacity, decisions=self.decisions,
            milp_calls=self.milp_calls, backfills=self.backfills,
            restarts=self.restarts,
        )

    def completed_stats(self) -> dict:
        """Running completion aggregates — O(1) memory in any mode.  In
        default mode they are derived from the retained ``completed`` list;
        in ``completed_summary`` mode from the running sums, so both modes
        report identical values for the same schedule."""
        if self.completed_summary:
            n, s_jct, s_wait = (self.completed_count, self._sum_jct,
                                self._sum_wait)
        else:
            n = len(self.completed)
            s_jct = sum(j.finish_time - j.submit_time for j in self.completed)
            s_wait = sum(j.first_start_time - j.submit_time
                         for j in self.completed)
        return {
            "completed": n,
            "mean_jct_s": s_jct / n if n else 0.0,
            "mean_wait_s": s_wait / n if n else 0.0,
            "gpu_seconds": self.gpu_seconds,
            "ring_len": len(self.completed_ring),
        }

    # --------------------------------------------------------- event logic ----
    def _effective_speed(self, placement: Placement) -> float:
        sp = min(self.cluster.speeds[i] * self.slow_nodes.get(i, 1.0)
                 for i in placement)
        return max(float(sp), 1e-3)

    def _job_speed(self, job: Job, placement: Placement) -> float:
        """Node-derived speed, scaled by gang size for resized elastic jobs
        (``runtime`` is defined at ``base_gpus``; work rate scales linearly
        with the current gang).  The factor is exactly 1.0 — and the
        resulting duration bit-identical to the pre-lifecycle engine —
        whenever the job runs at its submitted size."""
        speed = self._effective_speed(placement)
        if job.base_gpus > 0 and job.num_gpus != job.base_gpus:
            speed *= job.num_gpus / job.base_gpus
        return speed

    def _fire_hook(self, name: str, *args) -> None:
        """``getattr``-guarded dispatch for hooks added after observers were
        written (duck-typed, same contract as ``_fire_decision``)."""
        for h in self.hooks:
            fn = getattr(h, name, None)
            if fn is not None:
                fn(*args)

    def _start_job(self, job: Job, placement: Placement) -> None:
        self.cluster.allocate(job, placement)
        speed = self._job_speed(job, placement)
        dur = self.remaining[job.job_id] / speed
        finish = self.now + dur
        if job.start_time < 0:
            job.start_time = self.now
        if job.first_start_time < 0:
            job.first_start_time = self.now
        transition(job, JobState.RUNNING)
        job.placement = placement
        self.running[job.job_id] = [job, placement, self.now, finish, speed]
        if self.optimized:
            bisect.insort(self._finish_index, (finish, job.job_id))
        heapq.heappush(self._events,
                       (finish, next(self._seq), "finish", job.job_id))
        sp = spans.ACTIVE
        if sp is not None:
            sp.open("rltune.hooks")
        for h in self.hooks:
            h.on_start(job, self.now)
        if sp is not None:
            sp.close()
        if job.job_id in self._resume_pending:
            self._resume_pending.discard(job.job_id)
            self._fire_hook("on_resume", job, self.now)

    def _est_rt(self, job: Job) -> float:
        rt = job.est_runtime if self.prioritizer.use_estimates else job.runtime
        return max(rt, 1.0)

    def _lookahead_durations(self, rest: list[Job]) -> list[float] | None:
        """Predicted p50 durations for the MILP lookahead jobs when
        prediction assist is on; None (the declared-duration assumption,
        bit-identical to the pre-prediction solver) otherwise."""
        if not rest:
            return None
        pred = self._predict_assist()
        if pred is None:
            return None
        la = getattr(pred, "lookahead_durations", None)
        return la(rest, self) if la is not None else None

    def _alloc_for(self, job: Job, queue_rest: list[Job],
                   durations: list[float] | None = None) -> Placement | None:
        """Placement attempt for one job; with alloc observers attached
        (``repro_torch.obs``) each *successful* attempt is wall-clock timed and
        reported with the path that produced it (``milp`` /
        ``greedy-fallback`` / ``heuristic``, inferred from the solver
        counters).  Failed attempts are not dispatched — a deep backfill
        scan makes hundreds per decision, and they are already tallied in
        the audit record's skip counts; per-attempt hook calls there would
        dominate the decision latency the observers are meant to measure.
        With no observers the implementation is called directly — zero
        overhead when off."""
        obs = self._alloc_obs
        if not obs:
            return self._alloc_impl(job, queue_rest, durations)
        calls0, fb0 = self.milp_calls, self.milp_fallbacks
        t0 = time.perf_counter()
        placement = self._alloc_impl(job, queue_rest, durations)
        if placement is None:
            return None
        wall = time.perf_counter() - t0
        if self.milp_fallbacks > fb0:
            path = "greedy-fallback"
        elif self.milp_calls > calls0:
            path = "milp"
        else:
            path = "heuristic"
        for h in obs:
            h.on_alloc(job, placement, self.now, wall, path)
        return placement

    def _alloc_impl(self, job: Job, queue_rest: list[Job],
                    durations: list[float] | None = None) -> Placement | None:
        ways = self.cluster.candidate_ways(job)
        if not ways:
            return None
        if self.allocator in ("pack", "spread"):
            pl = self.cluster.find_placement(job, self.allocator)
            if pl is None:  # CPU/mem coupling edge: fall back to the other mode
                other = "spread" if self.allocator == "pack" else "pack"
                pl = self.cluster.find_placement(job, other)
            return pl
        use_solver = self.allocator == "milp"
        deg = self.degradation
        timed = False
        if use_solver and deg is not None:
            if self._deg_fallback_open > 0:
                # breaker open: take the greedy heuristic path for this
                # decision and count it when the solver would have run
                self._deg_fallback_open -= 1
                use_solver = False
                if len(ways) > 1:
                    self.milp_fallbacks += 1
            else:
                timed = len(ways) > 1
        if use_solver and len(ways) > 1:
            self.milp_calls += 1
        if not timed:
            res = choose_allocation(self.cluster, job, ways, queue_rest,
                                    lookahead_k=self.lookahead_k,
                                    use_solver=use_solver,
                                    durations=durations)
            return res.placement
        t_solve = time.perf_counter()
        res = choose_allocation(self.cluster, job, ways, queue_rest,
                                lookahead_k=self.lookahead_k,
                                use_solver=True, durations=durations)
        if time.perf_counter() - t_solve > deg.milp_budget_s:
            self._deg_slow_streak += 1
            if self._deg_slow_streak >= deg.trip_after:
                self._deg_fallback_open = deg.reset_after_decisions
                self._deg_slow_streak = 0
        else:
            self._deg_slow_streak = 0
        return res.placement

    # -- EASY backfill: earliest start for the reserved job -----------------
    def _earliest_start(self, job: Job) -> float:
        if not self.optimized:
            return self._earliest_start_naive(job)
        if self._scratch is None or \
                len(self._scratch.total_gpus) != len(self.cluster.total_gpus):
            # rebuild after add_node grew the cluster (spec reflects it)
            self._scratch = ClusterState(self.spec, cache=True)
        sim = self._scratch
        sim.load_from(self.cluster)
        if sim.find_placement(job, "pack") is not None:
            return self.now
        # the finish-time-ordered index replaces the per-call
        # sorted(self.running.items()) scan; jobs sharing a finish instant
        # release in job_id order instead of dict-insertion order, which
        # cannot change the returned bound (every member of a tie group
        # yields the same `fin`)
        for fin, jid in self._finish_index:
            rec = self.running[jid]
            sim.release(rec[0], rec[1])
            if sim.find_placement(job, "pack") is not None:
                return fin
        return float("inf")

    def _earliest_start_naive(self, job: Job) -> float:
        """Seed implementation: fresh ClusterState (four array allocations)
        per reservation.  Retained as the differential reference."""
        cluster = self.cluster
        sim = ClusterState(self.spec)
        sim.free_gpus = cluster.free_gpus.copy()
        sim.free_cpus = cluster.free_cpus.copy()
        sim.free_mem = cluster.free_mem.copy()
        sim.node_down = cluster.node_down.copy()
        sim.cordoned = cluster.cordoned.copy()
        sim.retired = cluster.retired.copy()
        if sim.find_placement(job, "pack") is not None:
            return self.now
        for jid, (rj, pl, st, fin, sp) in sorted(self.running.items(),
                                                 key=lambda kv: kv[1][3]):
            sim.release(rj, pl)
            if sim.find_placement(job, "pack") is not None:
                return fin
        return float("inf")

    def _kill_job(self, jid: int, preserve_ckpt: bool, *,
                  ckpt_interval: float | None = None,
                  resume_penalty: float = 0.0,
                  via: JobState | None = None,
                  requeue: bool = True) -> Job:
        """Evict a running job, floor its progress to the checkpoint grid,
        and (by default) requeue it.

        The fault path calls the original two-argument form and is
        bit-identical to the pre-lifecycle engine: the ckpt floor applies
        exactly when a fault injector is active, using
        ``fault_model.ckpt_interval``.  Lifecycle callers (preempt / pause /
        resize / migrate) pass an explicit ``ckpt_interval`` plus a
        ``resume_penalty`` (work-seconds, from ``CkptCostModel``) and may
        take over requeueing themselves: ``requeue=False`` leaves the job
        in the ``via`` state for the caller to route onward."""
        job, placement, st, fin, speed = self.running.pop(jid)
        if self._bf_deadlines:
            self._bf_deadlines.pop(jid, None)
        if self.optimized:
            self._finish_index_remove(fin, jid)
        self.cluster.release(job, placement)
        elapsed = max(0.0, self.now - st)
        work_done = elapsed * speed
        if preserve_ckpt:
            interval = ckpt_interval
            if interval is None and self._injector is not None:
                interval = self.fault_model.ckpt_interval
            if interval is not None:
                k = int(elapsed // interval)
                work_done = min(k * interval * speed, work_done)
        else:
            work_done = 0.0
        left = max(self.remaining[jid] - work_done, 1.0)
        # checkpointed-progress snapshot *before* the resume penalty: the
        # penalty is replayed restore work, not training progress
        job.progress_at_ckpt = max(
            0.0, 1.0 - min(left / max(job.runtime, 1e-9), 1.0))
        if resume_penalty > 0.0:
            left += resume_penalty
            self.resume_penalty_gpu_s += resume_penalty * job.num_gpus
        self.remaining[jid] = left
        job.placement = None
        job.restarts += 1
        self.restarts += 1
        if via is not None:
            transition(job, via)
        if requeue:
            if job.state is not JobState.PENDING:
                transition(job, JobState.PENDING)
            self._push_pending(job)
            for h in self.hooks:
                h.on_requeue(job, self.now)
        return job

    # ------------------------------------------------------ lifecycle ops ----
    def preempt_job(self, jid: int, cost=None) -> Job:
        """Checkpoint-evict a running job and requeue it (``RUNNING →
        PREEMPTED → PENDING``).  ``cost`` is a ``CkptCostModel`` (or None
        for penalty-free eviction on the fault-model ckpt grid): its
        ``ckpt_interval`` floors surviving progress and its
        ``resume_penalty`` is charged as extra remaining work.  Fires
        ``on_preempt`` (while the job is observably PREEMPTED) then
        ``on_requeue``."""
        if jid not in self.running:
            raise KeyError(f"job {jid} is not running")
        job = self.running[jid][0]
        interval = cost.ckpt_interval if cost is not None else None
        penalty = cost.resume_penalty(job) if cost is not None else 0.0
        job = self._kill_job(jid, preserve_ckpt=True, ckpt_interval=interval,
                             resume_penalty=penalty,
                             via=JobState.PREEMPTED, requeue=False)
        self.preemptions += 1
        self._resume_pending.add(jid)
        self._fire_hook("on_preempt", job, self.now, penalty)
        transition(job, JobState.PENDING)
        self._push_pending(job)
        for h in self.hooks:
            h.on_requeue(job, self.now)
        return job

    def pause_job(self, jid: int, cost=None) -> Job:
        """Checkpoint-suspend a running job (``RUNNING → PAUSED``): releases
        its GPUs and holds it *outside* the pending queue until
        :meth:`resume_job` or a cross-cluster migration picks it up."""
        if jid not in self.running:
            raise KeyError(f"job {jid} is not running")
        job = self.running[jid][0]
        interval = cost.ckpt_interval if cost is not None else None
        penalty = cost.resume_penalty(job) if cost is not None else 0.0
        job = self._kill_job(jid, preserve_ckpt=True, ckpt_interval=interval,
                             resume_penalty=penalty,
                             via=JobState.PAUSED, requeue=False)
        self.paused[jid] = job
        return job

    def resume_job(self, jid: int) -> Job:
        """Requeue a paused job (``PAUSED → PENDING``); it restarts from
        its checkpoint at the next scheduling pass."""
        job = self.paused.pop(jid, None)
        if job is None:
            raise KeyError(f"job {jid} is not paused")
        transition(job, JobState.PENDING)
        self._resume_pending.add(jid)
        self._push_pending(job)
        for h in self.hooks:
            h.on_requeue(job, self.now)
        return job

    @staticmethod
    def _apply_gang(job: Job, gpus: int) -> None:
        """Set an elastic job's gang size, re-deriving CPU/mem demand by
        the same GPU-proportionate rule as ``Job.__post_init__``."""
        job.num_gpus = gpus
        job.req_cpus = max(1, 4 * gpus)
        job.req_mem_gb = 32.0 * gpus

    def resize_job(self, jid: int, new_gpus: int, cost=None) -> bool:
        """Checkpoint-restart a running *elastic* job at a new gang size
        (clamped to ``[min_gpus, max_gpus]``).  The job restarts
        immediately when a placement at the new size exists; otherwise it
        reverts to the old size (the GPUs it just freed guarantee
        feasibility) and, failing even that, is requeued.  Returns True
        iff the size actually changed."""
        if jid not in self.running:
            raise KeyError(f"job {jid} is not running")
        job = self.running[jid][0]
        if not job.elastic:
            return False
        new_gpus = max(job.min_gpus, min(job.max_gpus, int(new_gpus)))
        old = job.num_gpus
        if new_gpus == old:
            return False
        interval = cost.ckpt_interval if cost is not None else None
        penalty = cost.resume_penalty(job) if cost is not None else 0.0
        job = self._kill_job(jid, preserve_ckpt=True, ckpt_interval=interval,
                             resume_penalty=penalty,
                             via=JobState.PREEMPTED, requeue=False)
        self.preemptions += 1
        self._resume_pending.add(jid)
        self._fire_hook("on_preempt", job, self.now, penalty)
        self._apply_gang(job, new_gpus)
        resized = True
        pl = self._alloc_for(job, [])
        if pl is None:
            self._apply_gang(job, old)
            resized = False
            pl = self._alloc_for(job, [])
        if pl is not None:
            self._start_job(job, pl)     # PREEMPTED -> RUNNING
        else:
            transition(job, JobState.PENDING)
            self._push_pending(job)
            for h in self.hooks:
                h.on_requeue(job, self.now)
        return resized

    def start_now(self, job: Job) -> bool:
        """Place and start a *pending* job immediately, outside prioritizer
        order (the deadline-lane fast path).  Returns False when no
        placement exists at the current instant."""
        pl = self._alloc_for(job, [])
        if pl is None:
            return False
        self._remove_pending(job)
        self._start_job(job, pl)
        return True

    def withdraw_pending(self, jid: int) -> tuple[Job, float]:
        """Drain a queued or paused job for migration (``→ MIGRATING``);
        returns ``(job, remaining_work)`` so the destination preserves
        progress.  The job stops counting against this engine's
        ``submitted`` the moment it leaves."""
        job = self.paused.pop(jid, None)
        if job is None:
            job = next((j for j in self.pending if j.job_id == jid), None)
            if job is None:
                raise KeyError(f"job {jid} is neither pending nor paused")
            self._remove_pending(job)
        transition(job, JobState.MIGRATING)
        self.submitted -= 1
        self._resume_pending.discard(jid)
        return job, self.remaining.pop(jid, job.runtime)

    def admit_migrated(self, job: Job, remaining: float) -> None:
        """Admit a job drained from another cluster (``MIGRATING →
        PENDING``), preserving its remaining work.  The arrival event is
        clamped to this engine's clock by ``submit``; callers should
        ``step``/``reschedule`` afterwards to ingest it."""
        transition(job, JobState.PENDING)
        if self.t0 is None:
            # first-ever job on this engine: anchor the stream at the
            # current clock, not at the migrant's original submit_time —
            # submit() must not drag the clock into the past
            self.t0 = self.now
        self.submit((job,))
        self.remaining[job.job_id] = remaining
        if remaining < job.runtime:
            self._resume_pending.add(job.job_id)

    # ------------------------------------------------------- chaos entry ----
    def force_fail(self, node: int, *,
                   ckpt_interval: float | None = None) -> int:
        """Chaos-injected node failure (rack burst / blackout member):
        identical semantics to an organic ``fail`` fault event — the node
        goes down and every running job touching it checkpoint-kills and
        requeues.  No-op (returns 0) on retired or already-down nodes, so
        bursts compose idempotently with organic timelines.  Returns the
        number of jobs killed."""
        cluster = self.cluster
        if node >= len(cluster.total_gpus) or cluster.retired[node] \
                or cluster.node_down[node]:
            return 0
        cluster.fail_node(node)
        hit = 0
        for jid in [jid for jid, rec in self.running.items()
                    if node in rec[1]]:
            self._kill_job(jid, preserve_ckpt=True,
                           ckpt_interval=ckpt_interval)
            hit += 1
        return hit

    def force_recover(self, node: int) -> bool:
        """Chaos-injected recovery; no-op on retired or up nodes."""
        cluster = self.cluster
        if node >= len(cluster.total_gpus) or cluster.retired[node] \
                or not cluster.node_down[node]:
            return False
        cluster.recover_node(node)
        return True

    def force_slow(self, node: int, slowdown: float) -> bool:
        """Chaos-injected straggling: the node degrades to ``slowdown``
        speed and running jobs rescale (or checkpoint-migrate, per the
        straggler-migration rule)."""
        if node >= len(self.cluster.total_gpus) \
                or self.cluster.retired[node]:
            return False
        self.slow_nodes[node] = float(slowdown)
        self._rescale_running(node)
        return True

    def force_unslow(self, node: int) -> bool:
        """Lift a chaos-injected slowdown."""
        if self.slow_nodes.pop(node, None) is None:
            return False
        self._rescale_running(node)
        return True

    def reclaim_node(self, node: int, cost) -> int:
        """Spot reclamation: *preempt* (not fault-kill) every running job
        touching ``node`` at the ``cost`` checkpoint economics — typically
        harsher than the organic fault grid — then take the node down.
        Jobs requeue through the normal preemption path (counted in both
        ``preemptions`` and ``reclaimed_jobs``); the node returns via
        :meth:`force_recover` when the wave's outage span elapses.
        Returns the number of jobs reclaimed."""
        cluster = self.cluster
        if node >= len(cluster.total_gpus) or cluster.retired[node] \
                or cluster.node_down[node]:
            return 0
        hit = 0
        for jid in [jid for jid, rec in self.running.items()
                    if node in rec[1]]:
            self.preempt_job(jid, cost)
            self.reclaimed_jobs += 1
            hit += 1
        cluster.fail_node(node)
        return hit

    def _finish_job(self, jid: int) -> None:
        rec = self.running.pop(jid, None)
        if rec is None:
            return
        job, placement, st, fin, speed = rec
        if self._bf_deadlines:
            self._bf_deadlines.pop(jid, None)
        if self.optimized:
            self._finish_index_remove(fin, jid)
        self.cluster.release(job, placement)
        job.finish_time = self.now
        transition(job, JobState.COMPLETED)
        self.gpu_seconds += job.num_gpus * (self.now - job.start_time)
        self.completed_count += 1
        if self.completed_summary:
            # compact mode: running aggregates + bounded tuple ring keep
            # memory O(completed_keep) on million-job streams
            self._sum_jct += job.finish_time - job.submit_time
            self._sum_wait += job.first_start_time - job.submit_time
            if job.finish_time > self._max_finish:
                self._max_finish = job.finish_time
            self.completed_ring.append(
                (job.job_id, job.submit_time, job.first_start_time,
                 job.finish_time, job.num_gpus, job.vc))
            self.remaining.pop(jid, None)
        else:
            self.completed.append(job)
        self.prioritizer.observe_finish(job)
        sp = spans.ACTIVE
        if sp is not None:
            sp.open("rltune.hooks")
        for h in self.hooks:
            h.on_finish(job, self.now)
        if sp is not None:
            sp.close()

    def _handle_faults(self) -> None:
        if self._injector is None:
            return
        for (ft, kind, node) in self._injector.pop_due(self.now):
            if kind == "fail":
                self.cluster.fail_node(node)
                for jid in [jid for jid, rec in self.running.items()
                            if node in rec[1]]:
                    self._kill_job(jid, preserve_ckpt=True)
            elif kind == "recover":
                self.cluster.recover_node(node)
            elif kind == "slow":
                self.slow_nodes[node] = self.fault_model.straggler_slowdown
                self._rescale_running(node)
            elif kind == "unslow":
                self.slow_nodes.pop(node, None)
                self._rescale_running(node)

    def _rescale_running(self, node: int) -> None:
        for jid, rec in list(self.running.items()):
            job, placement, st, fin, speed = rec
            if node not in placement:
                continue
            new_speed = self._job_speed(job, placement)
            if self.straggler_migration and new_speed < 0.6 * speed:
                # checkpoint + re-queue: the scheduler will replace it
                self._kill_job(jid, preserve_ckpt=True)
                continue
            left = max(fin - self.now, 0.0) * speed / new_speed
            rec[3] = self.now + left
            rec[4] = new_speed
            if self.optimized:
                self._finish_index_remove(fin, jid)
                bisect.insort(self._finish_index, (rec[3], jid))
            heapq.heappush(self._events,
                           (rec[3], next(self._seq), "finish", jid))

    # ------------------------------------------------------ schedulability ----
    def _any_schedulable(self, queue: list[Job]) -> bool:
        """Same boolean as ``any(can_schedule_now(j) for j in queue)`` but
        with a cheap necessary-condition prefilter (enough free GPUs of the
        requested SKU on up nodes) so saturated clusters skip the expensive
        placement search for the whole window.  On the optimized path the
        per-SKU tallies and per-shape feasibility come from the cluster's
        version-keyed cache, so repeat scans cost one dict hit per job."""
        if not self.optimized:
            return self._any_schedulable_naive(queue)
        cluster = self.cluster
        free_any, free_by_type = cluster.free_gpu_tallies()
        if free_any == 0:
            return False
        can = cluster.can_schedule_now
        for j in queue:
            avail = free_any if j.gpu_type == "any" \
                else free_by_type.get(j.gpu_type, 0)
            if avail >= j.num_gpus and can(j):
                return True
        return False

    def _any_schedulable_window(self, bound: int) -> bool:
        """``_any_schedulable`` over the first ``bound`` pending jobs
        *without* materializing the window slice — blocked passes on deep
        queues (the common case under saturation) pay a bounded scan over
        the already-sorted pending list and nothing else."""
        cluster = self.cluster
        free_any, free_by_type = cluster.free_gpu_tallies()
        if free_any == 0:
            return False
        can = cluster.can_schedule_now
        pending = self.pending
        for k in range(min(bound, len(pending))):
            j = pending[k]
            avail = free_any if j.gpu_type == "any" \
                else free_by_type.get(j.gpu_type, 0)
            if avail >= j.num_gpus and can(j):
                return True
        return False

    def _any_schedulable_naive(self, queue: list[Job]) -> bool:
        cluster = self.cluster
        up = cluster.placeable_mask()
        free_any = int(cluster.free_gpus[up].sum())
        if free_any == 0:
            return False
        free_by_type: dict[str, int] = {}
        for i, t in enumerate(cluster.gpu_types):
            if up[i]:
                free_by_type[t] = free_by_type.get(t, 0) + int(cluster.free_gpus[i])
        for j in queue:
            avail = free_any if j.gpu_type == "any" \
                else free_by_type.get(j.gpu_type, 0)
            if avail >= j.num_gpus and cluster.can_schedule_now(j):
                return True
        return False

    # ---------------------------------------------------------- scheduling ----
    def _fire_decision(self, queue: list[Job], order: list[int]) -> None:
        """Notify decision observers.  ``getattr``-guarded because hooks are
        duck-typed (pre-existing observers may not define ``on_decision``)."""
        sp = spans.ACTIVE
        if sp is not None:
            sp.open("rltune.hooks")
        for h in self.hooks:
            fn = getattr(h, "on_decision", None)
            if fn is not None:
                fn(queue, order, self.now, self)
        if sp is not None:
            sp.close()

    def _predict_assist(self):
        """The attached predictor, iff it should steer decisions (assist
        mode); None when off or in shadow mode."""
        p = self.predictor
        return p if p is not None and getattr(p, "assist", False) else None

    def _enforce_reservations(self) -> None:
        """Overrun handling for predictor-gated backfills: a backfilled job
        still running past its reservation deadline (plus the overrun
        policy's grace) while work is waiting is checkpoint-preempted
        through the normal ``preempt_job`` path at the policy's charged
        cost — the head job's reservation is honored instead of silently
        delayed.  Offenders are barred from further predictor-gated
        backfills.  Inert (never called) while no deadline is recorded."""
        pred = self.predictor
        pol = getattr(pred, "overrun", None) if pred is not None else None
        grace = getattr(pol, "grace_s", 0.0) if pol is not None else 0.0
        for jid, deadline in list(self._bf_deadlines.items()):
            if jid not in self.running:
                self._bf_deadlines.pop(jid, None)   # finished/killed already
                continue
            if self.now <= deadline + grace:
                continue
            if not self.pending:
                continue                 # nobody waiting: let it run on
            self._bf_deadlines.pop(jid, None)
            self._bf_overrun_jobs.add(jid)
            self.preempt_job(jid, pol)
            self.bf_overruns += 1

    def _try_schedule(self) -> None:
        if self._bf_deadlines:
            self._enforce_reservations()
        deg = self.degradation
        if deg is None:
            return self._schedule_pass()
        self._deg_roll(self.now)
        t_pass = time.perf_counter()
        try:
            self._schedule_pass()
        finally:
            self._deg_window_wall += time.perf_counter() - t_pass

    def _deg_roll(self, now: float) -> None:
        """Close elapsed degradation buckets.  A bucket whose accrued
        scheduling-pass wall time blew ``window_deadline_s`` forces the
        next ``fcfs_windows`` buckets of sim time to rank FCFS; the forced
        span is accounted to ``degraded_windows`` / ``degraded_s`` at trip
        time (overlap-free when trips chain)."""
        deg = self.degradation
        start = self._deg_window_start
        if start is None:
            self._deg_window_start = now
            return
        if now < start + deg.window_s:
            return
        blown = self._deg_window_wall > deg.window_deadline_s
        self._deg_window_wall = 0.0
        steps = int((now - start) // deg.window_s)
        edge = start + steps * deg.window_s
        self._deg_window_start = edge
        if blown:
            until = edge + deg.fcfs_windows * deg.window_s
            prev = self._deg_fcfs_until
            base = edge if prev is None or prev < edge else prev
            if until > base:
                add = until - base
                self.degraded_s += add
                self.degraded_windows += int(round(add / deg.window_s))
                self._deg_fcfs_until = until

    def _fcfs_degraded(self) -> bool:
        """True while the per-window circuit breaker holds the ranking at
        FCFS.  ``pending`` is (submit_time, job_id)-sorted on both engine
        paths at ranking time, so FCFS order is the identity permutation —
        no prioritizer call, no score batch."""
        return (self._deg_fcfs_until is not None
                and self.now < self._deg_fcfs_until)

    def _fire_audit(self, rec: dict) -> None:
        """Deliver one decision-audit record to the gated observers."""
        for h in self._audit_obs:
            h.on_decision_audit(rec)

    def _schedule_pass(self) -> None:
        if not self.optimized:
            return self._try_schedule_naive()
        cluster, prioritizer = self.cluster, self.prioritizer
        rank_window = self._rank_window
        #: with audit observers attached (repro_torch.obs) every decision builds
        #: one record — rank path, wall-clock, allocator path, skip-reason
        #: tallies — delivered via one on_decision_audit call; with none
        #: (`audit` empty, the default) no clock is read and no dict is
        #: built, keeping the pass bit-identical to the pre-obs engine
        audit = self._audit_obs
        sp = spans.ACTIVE
        while self.pending:
            # schedulability is checked straight off the sorted pending
            # list; the O(window) slice is deferred until something can
            # actually start, so blocked passes on deep queues are cheap
            if not self._any_schedulable_window(self.queue_window):
                if audit:
                    queued = min(self.queue_window, len(self.pending))
                    for h in self.hooks:
                        fn = getattr(h, "on_window_blocked", None)
                        if fn is not None:
                            fn(self.now, queued)
                return
            # pending is maintained sorted by (submit_time, job_id): window
            # extraction is a slice, no re-sort
            queue = self.pending[: self.queue_window]
            t_rank = time.perf_counter() if audit else 0.0
            if sp is not None:
                sp.open("rltune.rank")
            fcfs = self._fcfs_degraded()
            if fcfs:
                order = list(range(len(queue)))
            elif rank_window is not None:
                order = rank_window(queue, cluster, self.now,
                                    self._pindex.window(self.queue_window))
            else:
                order = prioritizer.rank(queue, cluster, self.now)
            if sp is not None:
                sp.close()
                sp.count("rank.decisions")
            self.decisions += 1
            if self.hooks:
                self._fire_decision(queue, order)
            top = queue[order[0]]
            rec = None
            if audit:
                rec = {"now": self.now,
                       "path": "fcfs-degraded" if fcfs else "policy",
                       "window": len(queue),
                       "rank_wall_s": time.perf_counter() - t_rank,
                       "top_job": top.job_id, "placed": False,
                       "alloc": "none", "skips": {}, "backfills": 0}
            k_look = self.lookahead_k
            if (self.deep_lookahead_k is not None
                    and len(self.pending) > self.deep_queue_threshold):
                k_look = min(k_look, self.deep_lookahead_k)
            rest = [queue[i] for i in order[1:1 + k_look]]
            durations = self._lookahead_durations(rest)
            calls0, fb0 = self.milp_calls, self.milp_fallbacks
            if sp is not None:
                sp.open("rltune.place.head")
            placement = self._alloc_for(top, rest, durations)
            if sp is not None:
                sp.close(None if placement is not None
                         else "rltune.place.head_failed")
            if placement is not None:
                if rec is not None:
                    rec["placed"] = True
                    rec["alloc"] = ("greedy-fallback"
                                    if self.milp_fallbacks > fb0
                                    else "milp"
                                    if self.milp_calls > calls0
                                    else "heuristic")
                    self._fire_audit(rec)
                self._remove_pending(top)
                self._start_job(top, placement)
                continue
            if rec is not None:
                rec["skips"]["head-no-placement"] = 1
            if not self.backfill:
                if rec is not None:
                    self._fire_audit(rec)
                if sp is not None:
                    sp.count("rank.futile")
                return
            # EASY backfill under reservation for `top`.  The audit skip
            # tallies use local ints folded into the record after the loop:
            # a deep window makes O(queue_window) skips per decision, and
            # per-skip dict updates would show up in the decision latency
            # the audit record itself reports.  Candidate placements go
            # straight to ``_alloc_impl`` for the same reason (identical to
            # ``_alloc_for`` when no observers are attached) — alloc spans
            # cover head-of-queue placements; backfill starts are counted
            # in the record's ``backfills`` field.
            if sp is not None:
                sp.open("rltune.backfill")
                sp.open("rltune.backfill.reserve")
                bf0 = self.backfills
            t_res = self._earliest_start(top)
            if sp is not None:
                sp.close()
            progressed = False
            # Vectorized candidate filter over the pending-index columns.
            # The pindex still mirrors `queue` row-for-row (nothing was
            # removed since the slice — the head alloc just failed), so the
            # scalar reference's per-candidate test
            # ``now + max(rt, 1.0) > t_res`` is evaluated for the whole
            # window in one float64 expression with identical operations.
            # Every entry of order[1:] is a distinct PENDING job != top at
            # this instant (pending holds only PENDING jobs and order is a
            # permutation), so tallying overruns off the raw mask matches
            # the scalar loop's count exactly.
            pindex = self._pindex
            w = len(queue)
            pred = self._predict_assist()
            if pred is not None:
                # prediction-assisted gate: a candidate backfills only if
                # its predicted p90 runtime fits before the reservation —
                # conservative quantile in place of the declared runtime.
                # Jobs that already blew a reservation are barred.
                p90 = np.maximum(pred.reserve_batch(queue, self), 1.0)
                time_ok = self.now + p90 <= t_res
                barred = self._bf_overrun_jobs
                if barred:
                    for k, cj in enumerate(queue):
                        if cj.job_id in barred:
                            time_ok[k] = False
            else:
                rt_col = pindex._est if prioritizer.use_estimates \
                    else pindex._rt
                time_ok = self.now + np.maximum(rt_col[:w], 1.0) <= t_res
            sid_snap = pindex._sid[:w].copy()   # survives removals below
            order_arr = np.asarray(order[1:], dtype=np.intp)
            ok = time_ok[order_arr]
            sk_over = int(ok.size) - int(ok.sum())
            neg = self._neg_shapes
            if cluster.version != self._neg_ver:
                self._neg_ver = cluster.version
                neg.clear()
            free_any, free_by_type = cluster.free_gpu_tallies()
            sk_nopl = 0
            failed = 0
            for i in order_arr[ok]:
                cand = queue[i]
                if cand.state != JobState.PENDING or cand is top:
                    continue   # unreachable by the invariant above; kept
                sid = sid_snap[i]
                if sid in neg:
                    # shape already proven unplaceable at this cluster
                    # version — same None `_alloc_impl` would return
                    sk_nopl += 1
                    continue
                # free-tally prefilter: a per-SKU shortfall is a proof of
                # infeasibility (the same necessary condition
                # `_any_schedulable` uses), so `_alloc_impl` would return
                # None — skip the candidate-ways probe entirely
                avail = free_any if cand.gpu_type == "any" \
                    else free_by_type.get(cand.gpu_type, 0)
                if avail < cand.num_gpus:
                    neg.add(sid)
                    sk_nopl += 1
                    continue
                pl = self._alloc_impl(cand, [])
                if pl is not None:
                    self._remove_pending(cand)
                    self._start_job(cand, pl)
                    self.backfills += 1
                    progressed = True
                    if pred is not None and t_res < math.inf:
                        self.bf_reservations += 1
                        self._bf_deadlines[cand.job_id] = t_res
                        note = getattr(pred, "note_reservation", None)
                        if note is not None:
                            note(t_res - (self.now + float(p90[i])))
                    if rec is not None:
                        rec["backfills"] += 1
                    # the allocation bumped cluster.version: start fresh
                    self._neg_ver = cluster.version
                    neg.clear()
                    free_any, free_by_type = cluster.free_gpu_tallies()
                else:
                    neg.add(sid)
                    sk_nopl += 1
                    failed += 1
            if rec is not None:
                if sk_over:
                    rec["skips"]["backfill-overrun"] = sk_over
                if sk_nopl:
                    rec["skips"]["backfill-no-placement"] = sk_nopl
                self._fire_audit(rec)
            if sp is not None:
                sp.add(("backfill.tried", self.backfills - bf0 + failed),
                       ("backfill.failed", failed),
                       ("rank.futile", not progressed))
                sp.close()
            if not progressed:
                return
            # after backfills the reserved job may now fit; loop again
            if not cluster.can_schedule_now(top):
                return

    # ------------------------------------------------------------ failover ----
    #: everything a restored engine needs to resume bit-identically.  Hooks
    #: are deliberately absent (observational; the restoring driver re-
    #: attaches its own), as are the derived caches ``_scratch`` /
    #: ``_pindex`` / ``_rank_window`` and the gated hook-dispatch lists
    #: ``_alloc_obs`` / ``_audit_obs`` (rebuilt on load).
    _STATE_ATTRS = (
        "spec", "prioritizer", "allocator", "backfill", "lookahead_k",
        "fault_model", "straggler_migration", "max_sim_time", "queue_window",
        "optimized", "degradation", "cluster", "_seq", "_events", "pending",
        "running", "_finish_index", "remaining", "completed", "gpu_seconds",
        "decisions", "milp_calls", "backfills", "restarts", "preemptions",
        "resume_penalty_gpu_s", "paused", "_resume_pending", "slow_nodes",
        "now", "t0", "submitted", "_injector", "_guard", "_guard_budget",
        "reclaimed_jobs", "milp_fallbacks", "degraded_windows", "degraded_s",
        "_deg_fallback_open", "_deg_slow_streak", "_deg_window_start",
        "_deg_window_wall", "_deg_fcfs_until",
        "completed_summary", "completed_count", "completed_ring",
        "_sum_jct", "_sum_wait", "_max_finish",
        "deep_lookahead_k", "deep_queue_threshold",
        "predictor", "bf_reservations", "bf_overruns", "_bf_deadlines",
        "_bf_overrun_jobs",
    )

    def save_state(self) -> bytes:
        """Serialize the full scheduling state (clock, event heap, queues,
        running set, fault timeline, counters) so a crashed control plane
        can restore mid-stream and resume **bit-identically** to a run that
        never crashed (pinned by ``tests/test_failover.py``).

        One ``pickle.dumps`` over the whole attribute dict keeps shared
        ``Job`` identity intact (a job referenced from both the pending
        queue and a queued arrival event restores as one object).  A
        prioritizer back-reference to the engine (``QuotaPrioritizer``'s
        differential path) is detached for the dump and restored after."""
        pri = self.prioritizer
        had_ref = hasattr(pri, "engine")
        ref = getattr(pri, "engine", None)
        if had_ref:
            pri.engine = None
        try:
            state = {name: getattr(self, name) for name in self._STATE_ATTRS}
            return pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
        finally:
            if had_ref:
                pri.engine = ref

    @classmethod
    def load_state(cls, blob: bytes,
                   hooks: Iterable[EngineHooks] = ()) -> "SchedulerEngine":
        """Restore an engine from :meth:`save_state`.  ``hooks`` re-attaches
        the restoring driver's observers (telemetry, RL recorders); an
        incremental ``QuotaPrioritizer`` travelling inside the blob is
        re-appended as a hook automatically, its pickled usage intact."""
        state = pickle.loads(blob)
        eng = cls.__new__(cls)
        for name, value in state.items():
            setattr(eng, name, value)
        eng.hooks = list(hooks)
        # derived caches: rebuilt, never pickled
        eng._scratch = None
        if eng.optimized:
            eng._pindex = _PendingFieldIndex()
            for idx, job in enumerate(eng.pending):
                eng._pindex.insert(idx, job)
        else:
            eng._pindex = None
        eng._rank_window = getattr(eng.prioritizer, "rank_window", None)
        eng._neg_shapes = set()
        eng._neg_ver = -1
        pri = eng.prioritizer
        if hasattr(pri, "engine"):
            pri.engine = eng
        if isinstance(pri, EngineHooks) and getattr(pri, "incremental",
                                                    False):
            eng.hooks.append(pri)
        # a predictor travelling inside the blob (trained weights, MAPE
        # state) is rebound and re-attached as a hook so training resumes
        pred = eng.predictor
        if pred is not None:
            bind = getattr(pred, "bind", None)
            if bind is not None:
                bind(eng)
            if pred not in eng.hooks:
                eng.hooks.append(pred)
        eng._rebuild_hook_dispatch()
        spans.follow_profiler()
        return eng

    def _try_schedule_naive(self) -> None:
        """Seed decision loop: full re-sort + linear `.remove()` per decision.
        Retained verbatim as the reference for differential equivalence."""
        cluster, prioritizer = self.cluster, self.prioritizer
        while self.pending:
            self.pending.sort(key=lambda j: (j.submit_time, j.job_id))
            queue = self.pending[: self.queue_window]
            if not self._any_schedulable(queue):
                return
            if self._fcfs_degraded():
                order = list(range(len(queue)))
            else:
                order = prioritizer.rank(queue, cluster, self.now)
            self.decisions += 1
            if self.hooks:
                self._fire_decision(queue, order)
            top = queue[order[0]]
            rest = [queue[i] for i in order[1:1 + self.lookahead_k]]
            placement = self._alloc_for(top, rest,
                                        self._lookahead_durations(rest))
            if placement is not None:
                self.pending.remove(top)
                self._start_job(top, placement)
                continue
            if not self.backfill:
                return
            # EASY backfill under reservation for `top`
            t_res = self._earliest_start(top)
            progressed = False
            pred = self._predict_assist()
            for i in order[1:]:
                cand = queue[i]
                if cand.state != JobState.PENDING or cand is top:
                    continue
                if pred is not None:
                    if cand.job_id in self._bf_overrun_jobs:
                        continue
                    rt = max(float(pred.reserve_runtime(cand, self)), 1.0)
                else:
                    rt = self._est_rt(cand)
                if self.now + rt > t_res:
                    continue
                pl = self._alloc_for(cand, [])
                if pl is not None:
                    self.pending.remove(cand)
                    self._start_job(cand, pl)
                    self.backfills += 1
                    progressed = True
                    if pred is not None and t_res < math.inf:
                        self.bf_reservations += 1
                        self._bf_deadlines[cand.job_id] = t_res
                        note = getattr(pred, "note_reservation", None)
                        if note is not None:
                            note(t_res - (self.now + rt))
            if not progressed:
                return
            # after backfills the reserved job may now fit; loop again
            if not cluster.can_schedule_now(top):
                return

"""Preemption controller: one lifecycle tick per rescan window.

Mirrors the autoscaler contract (``repro_torch.scale.Autoscaler.control``): the
service loop calls :meth:`PreemptionController.control` once per *processed*
rescan window, after the autoscaler tick.  The controller advances the engine
clock to the window edge, lets each policy act through the engine's lifecycle
entry points (``preempt_job`` / ``resize_job`` / ``start_now`` — every one a
checkpoint-restore move charged by the shared :class:`CkptCostModel`), and
kicks ``engine.reschedule`` so freed capacity is reused at the same instant.

With no controller configured (``preemption=None``) the service loop touches
zero engine code paths — pinned bit-identical by tests, like the
autoscaler-off path.

Policies are duck-typed: anything with
``tick(engine, now, cost) -> list[PreemptionEvent]``.

- :class:`SloDeadlinePolicy` — SLO-lane deadline enforcement.  A pending
  deadline job that can no longer wait (``now + est_runtime + slack >=
  deadline``) is force-started; when the cluster is full, the policy evicts
  the cheapest set of best-effort victims (least checkpoint-lost work first)
  whose release makes the gang fit, verified on a scratch ``ClusterState``
  before any real eviction.
- :class:`ElasticGangPolicy` — grow/shrink for jobs flagged elastic
  (``0 < min_gpus < max_gpus``): backlog pressure shrinks the largest
  elastic gangs toward ``min_gpus`` to admit queued work; an idle cluster
  grows the smallest gangs back toward ``max_gpus``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.cluster import ClusterState
from repro_torch.core.types import Job
from repro_torch.lifecycle.costs import CkptCostModel


@dataclasses.dataclass(frozen=True)
class PreemptionEvent:
    """One lifecycle action taken by a controller policy."""

    time: float
    action: str        # "preempt" | "deadline-start" | "shrink" | "grow"
    job_id: int
    reason: str
    penalty_s: float = 0.0


class SloDeadlinePolicy:
    """Evict best-effort work so deadline jobs start in time.

    ``slack_s`` is the safety margin subtracted from the latest feasible
    start; ``max_victims_per_tick`` bounds collateral damage per window;
    ``scan`` bounds the pending-queue prefix examined (the queue is
    submit-ordered, so deadline storms are near the head in practice).
    """

    def __init__(self, *, slack_s: float = 600.0,
                 max_victims_per_tick: int = 8, scan: int = 256):
        self.slack_s = slack_s
        self.max_victims_per_tick = max_victims_per_tick
        self.scan = scan

    def _urgent(self, job: Job, now: float) -> bool:
        est = max(job.est_runtime, 1.0)
        return now + est + self.slack_s >= job.deadline

    def tick(self, engine, now: float, cost: CkptCostModel) \
            -> list[PreemptionEvent]:
        events: list[PreemptionEvent] = []
        victims_left = self.max_victims_per_tick
        urgent = [j for j in engine.pending[:self.scan]
                  if j.has_deadline and self._urgent(j, now)]
        # most imminent deadline first; job_id tie-break keeps it deterministic
        urgent.sort(key=lambda j: (j.deadline, j.job_id))
        for job in urgent:
            if engine.start_now(job):
                events.append(PreemptionEvent(
                    now, "deadline-start", job.job_id,
                    f"deadline {job.deadline:.0f}s, free capacity"))
                continue
            if victims_left <= 0:
                continue
            victims = self._pick_victims(engine, job, victims_left)
            if victims is None:
                continue
            for vid, lost in victims:
                pen = cost.resume_penalty(engine.running[vid][0])
                engine.preempt_job(vid, cost)
                events.append(PreemptionEvent(
                    now, "preempt", vid,
                    f"evicted for deadline job {job.job_id}", pen))
                victims_left -= 1
            if engine.start_now(job):
                events.append(PreemptionEvent(
                    now, "deadline-start", job.job_id,
                    f"deadline {job.deadline:.0f}s, "
                    f"after {len(victims)} eviction(s)"))
        return events

    def _pick_victims(self, engine, job: Job, budget: int):
        """Cheapest best-effort victim set whose release fits ``job``,
        verified on a scratch cluster; None when no such set exists within
        ``budget`` evictions."""
        cands = []
        for jid, rec in engine.running.items():
            victim, _, st, _, speed = rec
            if victim.has_deadline:
                continue
            # uncheckpointed progress a preemption replays;
            # least-lost-first minimizes waste
            elapsed = max(0.0, engine.now - st)
            cands.append((elapsed * speed, jid))
        if not cands:
            return None
        cands.sort(key=lambda t: (t[0], t[1]))
        sim = ClusterState(engine.spec)
        sim.load_from(engine.cluster)
        chosen: list[tuple[int, float]] = []
        for lost_work, jid in cands[:budget]:
            rec = engine.running[jid]
            sim.release(rec[0], rec[1])
            chosen.append((jid, lost_work))
            if sim.find_placement(job, "pack") is not None:
                return chosen
        return None


class ElasticGangPolicy:
    """Resize elastic gangs against queue pressure.

    Shrink: while jobs queue and free capacity can't admit the queue head,
    halve the largest elastic gang (toward ``min_gpus``).  Grow: with an
    empty queue and idle GPUs, double the smallest resized gang back toward
    ``max_gpus``.  Both are checkpoint-restarts charged by the cost model;
    ``max_resizes_per_tick`` bounds churn per window.
    """

    def __init__(self, *, max_resizes_per_tick: int = 4):
        self.max_resizes_per_tick = max_resizes_per_tick

    def tick(self, engine, now: float, cost: CkptCostModel) \
            -> list[PreemptionEvent]:
        events: list[PreemptionEvent] = []
        budget = self.max_resizes_per_tick
        free, _ = engine.cluster.free_gpu_tallies()
        if engine.pending:
            head = engine.pending[0]
            # shrink the largest shrinkable gangs until the head would fit
            shrinkable = sorted(
                ((rec[0].num_gpus, jid) for jid, rec in
                 engine.running.items()
                 if rec[0].elastic and rec[0].num_gpus > rec[0].min_gpus),
                key=lambda t: (-t[0], t[1]))
            for gang, jid in shrinkable:
                if budget <= 0 or free >= head.num_gpus:
                    break
                job = engine.running[jid][0]
                target = max(job.min_gpus, gang // 2)
                pen = cost.resume_penalty(job)
                if engine.resize_job(jid, target, cost):
                    freed = gang - engine.running[jid][0].num_gpus \
                        if jid in engine.running else gang - target
                    free += freed
                    budget -= 1
                    events.append(PreemptionEvent(
                        now, "shrink", jid,
                        f"backlog: {gang} -> {target} GPUs frees capacity",
                        pen))
        elif free > 0:
            growable = sorted(
                ((rec[0].num_gpus, jid) for jid, rec in
                 engine.running.items()
                 if rec[0].elastic and rec[0].num_gpus < rec[0].max_gpus),
                key=lambda t: (t[0], t[1]))
            for gang, jid in growable:
                if budget <= 0:
                    break
                job = engine.running[jid][0]
                target = min(job.max_gpus, gang * 2, gang + free)
                if target <= gang:
                    continue
                pen = cost.resume_penalty(job)
                if engine.resize_job(jid, target, cost):
                    grown = engine.running[jid][0].num_gpus - gang \
                        if jid in engine.running else target - gang
                    free -= grown
                    budget -= 1
                    events.append(PreemptionEvent(
                        now, "grow", jid,
                        f"idle capacity: {gang} -> {target} GPUs", pen))
        return events


class PreemptionController:
    """Runs the configured policies once per rescan window.

    Tick ordering (documented in ``docs/ARCHITECTURE.md``): the service loop
    fires the autoscaler first (capacity moves), then this controller
    (placement moves against the post-scaling cluster), then ``on_window``
    observers.  The controller advances the engine to the window edge
    before acting so every lifecycle event is stamped at the tick instant,
    and kicks one extra scheduling pass when anything changed.
    """

    def __init__(self, policies=None, cost: CkptCostModel | None = None):
        if policies is None:
            policies = (SloDeadlinePolicy(), ElasticGangPolicy())
        self.policies = list(policies)
        self.cost = cost if cost is not None else CkptCostModel()
        self.events: list[PreemptionEvent] = []

    def control(self, engine, now: float, telemetry=None) \
            -> list[PreemptionEvent]:
        if now > engine.now:
            # window-edge alignment, decision-free: a controller whose
            # policies never act stays bit-identical, counters included
            engine.advance_to(now)
        events: list[PreemptionEvent] = []
        for p in self.policies:
            events.extend(p.tick(engine, now, self.cost))
        if events:
            self.events.extend(events)
            if telemetry is not None:
                note = getattr(telemetry, "note_preemption_events", None)
                if note is not None:
                    note(events)
            engine.reschedule(at=now)
        return events

    def event_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for e in self.events:
            counts[e.action] = counts.get(e.action, 0) + 1
        return counts

"""Cross-cluster job migration policy for the federation layer.

``FederatedScheduler`` routes each job once, at submit time; under skewed
load (a fault storm taking half a member's nodes down, a burst landing on
one cluster) that one-shot assignment goes stale.  A migration policy runs
at every lockstep window edge, after the autoscaler ticks and view refresh:
it re-routes *waiting* work — PENDING queue entries and PAUSED jobs, never
running gangs — through the federation's own router against fresh snapshots
and proposes moves whose load advantage clears a hysteresis threshold.

The federation executes each move as drain + resubmit with preserved
progress: ``engine.withdraw_pending`` (→ MIGRATING) on the source,
``engine.admit_migrated`` (→ PENDING, remaining work carried over) on the
destination, with a ``MigrationEvent`` recorded and telemetry on both sides
updated.  Policies are duck-typed: anything with
``pick(fed, now) -> list[MigrationEvent]``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.types import JobState


@dataclasses.dataclass(frozen=True)
class MigrationEvent:
    """One cross-cluster move decided at a window edge."""

    time: float
    job_id: int
    src: int
    dst: int
    reason: str


class QueueImbalanceMigration:
    """Move queued/paused jobs from overloaded members to better homes.

    A job migrates only when the federation's router, shown current views,
    would place it elsewhere AND the source's queue load exceeds the
    destination's by at least ``min_advantage`` jobs (hysteresis — without
    it, near-balanced fleets would shuttle jobs every window).
    ``max_moves_per_window`` bounds churn; ``scan`` bounds the per-source
    pending-prefix examined.  Proposed loads are updated move-by-move so a
    single window cannot dogpile one destination.
    """

    name = "queue-imbalance"

    def __init__(self, *, min_advantage: int = 8,
                 max_moves_per_window: int = 4, scan: int = 64):
        self.min_advantage = min_advantage
        self.max_moves_per_window = max_moves_per_window
        self.scan = scan

    def pick(self, fed, now: float) -> list[MigrationEvent]:
        views = fed._views
        if len(views) < 2:
            return []
        loads = [v.queue_load for v in views]
        moves: list[MigrationEvent] = []
        budget = self.max_moves_per_window
        order = sorted(range(len(views)), key=lambda i: (-loads[i], i))
        for src in order:
            if budget <= 0:
                break
            eng = fed.engines[src]
            waiting = [j for j in eng.pending[:self.scan]
                       if j.state is JobState.PENDING]
            waiting += [eng.paused[jid] for jid in sorted(eng.paused)]
            for job in waiting:
                if budget <= 0:
                    break
                dst = fed.router.route(job, views)
                if dst == src:
                    continue
                if loads[src] - loads[dst] < self.min_advantage:
                    continue
                moves.append(MigrationEvent(
                    now, job.job_id, src, dst,
                    f"queue load {loads[src]} vs {loads[dst]} "
                    f"(router: {fed.router.name})"))
                loads[src] -= 1
                loads[dst] += 1
                budget -= 1
        return moves

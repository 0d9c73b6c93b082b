"""Control-plane degradation ladder.

The engine's decision loop assumes it never runs late: every rescan may
solve a MILP per queued job, and ranking walks the whole window.  Under
chaos (mass requeues after a rack burst, reclamation waves) the queue
balloons and a real control plane would blow its decision deadline.  The
ladder trades decision *quality* for decision *latency*, rung by rung:

1. **MILP budget** — each ``choose_allocation`` solver call is timed; a
   streak of ``trip_after`` consecutive over-budget solves opens a circuit
   breaker and the next ``reset_after_decisions`` decisions take the
   greedy heuristic path instead (counted as ``milp_fallbacks``).
2. **FCFS windows** — scheduling-pass wall time is accumulated into
   sim-time buckets of ``window_s``; a bucket exceeding
   ``window_deadline_s`` forces the next ``fcfs_windows`` buckets to rank
   the queue FCFS (arrival order) instead of calling the prioritizer
   (counted as ``degraded_windows`` / ``degraded_s``).

A ``degradation=None`` engine never reads the clock — the pinned
bit-identical default.  The policy object is duck-typed by the engine
(``repro_torch.sched`` never imports this package).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """Budgets for the two degradation rungs.  All wall-clock seconds."""

    milp_budget_s: float = 0.05        # per-solve budget for the MILP path
    trip_after: int = 3                # consecutive over-budget solves to trip
    reset_after_decisions: int = 64    # greedy decisions before retrying MILP
    window_s: float = 60.0             # sim-time bucket for pass wall time
    window_deadline_s: float = 0.5     # wall budget per bucket
    fcfs_windows: int = 2              # buckets ranked FCFS after a blown one

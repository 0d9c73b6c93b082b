"""Decision audit log: which path ranked, which allocator placed, and why
jobs were skipped.

The engine's gated audit stream (``on_decision_audit`` /
``on_window_blocked``, see ``repro_torch.sched.engine``) emits one record per
scheduling decision on the optimized path:

.. code-block:: python

    {"now": float,            # simulated decision instant
     "path": "policy" | "fcfs-degraded",     # who ranked the window
     "window": int,           # ranking-window size handed to the policy
     "rank_wall_s": float,    # wall-clock spent ranking
     "top_job": int,          # job id the policy put first
     "placed": bool,          # did the top job start this decision
     "alloc": "milp" | "greedy-fallback" | "heuristic" | "none",
     "skips": {reason: count},  # head-no-placement / backfill-overrun /
                                # backfill-no-placement
     "backfills": int}        # jobs EASY-backfilled under the reservation

``DecisionAuditLog`` aggregates the stream into exact cumulative counters
(path / allocator / skip-reason tallies, blocked-window count) and keeps
the most recent ``keep`` raw records for inspection — the aggregates are
never truncated, only the raw ring is.  ``python -m repro_torch.obs.report``
prints the same summaries from an exported trace file.
"""
from __future__ import annotations

import collections

from repro_torch.sched.engine import EngineHooks

#: skip reasons the engine reports (order = display order for ties)
SKIP_REASONS = ("head-no-placement", "backfill-overrun",
                "backfill-no-placement")


class DecisionAuditLog(EngineHooks):
    """Aggregating sink for the engine's decision-audit stream.

    Subclasses ``EngineHooks`` so it can be attached directly to an engine
    (the base-event dispatch calls every hook unconditionally); the gated
    audit stream still fires only because this class *overrides*
    ``on_decision_audit`` / ``on_window_blocked``."""

    def __init__(self, keep: int = 10_000):
        self.keep = keep
        self.records: collections.deque = collections.deque(maxlen=keep)
        self.decisions = 0
        self.path_counts: collections.Counter = collections.Counter()
        self.alloc_counts: collections.Counter = collections.Counter()
        self.skip_counts: collections.Counter = collections.Counter()
        self.backfills = 0
        self.blocked_windows = 0
        self.rank_wall_s = 0.0

    # ----------------------------------------------------------- hook API ----
    def on_decision_audit(self, rec: dict) -> None:
        self.decisions += 1
        self.path_counts[rec["path"]] += 1
        self.alloc_counts[rec.get("alloc", "none")] += 1
        self.rank_wall_s += rec.get("rank_wall_s", 0.0)
        self.backfills += rec.get("backfills", 0)
        for reason, n in rec.get("skips", {}).items():
            self.skip_counts[reason] += n
        self.records.append(rec)

    def on_window_blocked(self, now: float, queued: int) -> None:
        self.blocked_windows += 1

    # ------------------------------------------------------------ queries ----
    def top_skip_reasons(self, k: int = 3) -> list[tuple[str, int]]:
        """Top-k reasons queued jobs were passed over, most frequent
        first (ties in the engine's reporting order)."""
        order = {r: i for i, r in enumerate(SKIP_REASONS)}
        items = sorted(self.skip_counts.items(),
                       key=lambda kv: (-kv[1], order.get(kv[0], 99)))
        return items[:k]

    def summary(self) -> dict:
        """JSON-friendly aggregate (bench artifacts embed this)."""
        return {
            "decisions": self.decisions,
            "path_counts": dict(self.path_counts),
            "alloc_counts": dict(self.alloc_counts),
            "skip_counts": dict(self.skip_counts),
            "top_skip_reasons": self.top_skip_reasons(),
            "backfills": self.backfills,
            "blocked_windows": self.blocked_windows,
            "rank_wall_s": self.rank_wall_s,
            "records_kept": len(self.records),
        }

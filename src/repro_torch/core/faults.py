"""Fault-tolerance model for the cluster simulator.

Node failures (Poisson per node), repair times, straggler (slow-node) events,
and job checkpoint/restart semantics: a killed job loses work back to its last
checkpoint and is re-queued.  The scheduler sees failures only through the
cluster state (fewer free GPUs, re-queued jobs aging) — consistent with the
paper's application-agnostic stance.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np


@dataclasses.dataclass
class FaultModel:
    """Configuration for failure injection."""

    mtbf_per_node: float = 30 * 86400.0      # mean time between failures, per node
    repair_time: float = 2 * 3600.0
    straggler_prob: float = 0.01             # P(node slows) per failure draw
    straggler_slowdown: float = 0.5          # speed multiplier while straggling
    straggler_duration: float = 4 * 3600.0
    ckpt_interval: float = 1800.0            # job checkpoint period (seconds)
    seed: int = 0


class FaultInjector:
    """Generates failure / recovery / straggler events for a cluster.

    Timelines are drawn per node from one sequential RNG at construction
    (deterministic in ``model.seed``), so two injectors over the same model
    and node count carry byte-identical event heaps.  Two invariants:

    - **Pair-closing**: every ``fail``/``slow`` pushes its matching
      ``recover``/``unslow`` companion even when the companion lands past
      ``horizon`` — only the *failure draw* is horizon-bounded, so a node
      can never end a run permanently failed or slowed by timeline
      truncation (pinned by ``tests/test_faults.py``).
    - **Extension determinism**: nodes added at runtime (autoscaler
      scale-ups) get their own timeline via :meth:`extend_node`, seeded by
      ``(model.seed, node_id)`` — independent of when the node appears and
      of every other node's draws, so a grown cluster replays identically.
    """

    def __init__(self, model: FaultModel, num_nodes: int, horizon: float):
        self.model = model
        self.num_nodes = num_nodes
        self.horizon = horizon
        rng = np.random.default_rng(model.seed)
        self.events: list[tuple[float, str, int]] = []  # (time, kind, node)
        for node in range(num_nodes):
            self._draw_timeline(rng, node, 0.0)

    def _draw_timeline(self, rng, node: int, start: float) \
            -> list[tuple[float, str, int]]:
        """Draw one node's failure/straggler timeline from ``start`` and
        push it onto the heap (in draw order, exactly as the seed
        constructor did).  Companion (recover/unslow) events are pushed
        unconditionally — the pair-close invariant.  Returns the pushed
        events."""
        model = self.model
        drawn: list[tuple[float, str, int]] = []
        t = start
        while True:
            t += float(rng.exponential(model.mtbf_per_node))
            if t >= self.horizon:
                break
            if rng.random() < model.straggler_prob:
                drawn.append((t, "slow", node))
                drawn.append((t + model.straggler_duration, "unslow", node))
            else:
                drawn.append((t, "fail", node))
                drawn.append((t + model.repair_time, "recover", node))
        for e in drawn:
            heapq.heappush(self.events, e)
        return drawn

    def extend_node(self, node: int, start: float) \
            -> list[tuple[float, str, int]]:
        """Seed a deterministic failure timeline for a node added at
        runtime (autoscaler scale-up), starting its MTBF clock at ``start``.
        The timeline is drawn from a fresh RNG seeded by ``(model.seed,
        node)``, so it depends only on the model and the node id — never on
        how many events the construction-time RNG consumed.  Returns the
        newly pushed events (the engine mirrors them as marker events)."""
        rng = np.random.default_rng([self.model.seed, node])
        drawn = self._draw_timeline(rng, node, start)
        self.num_nodes = max(self.num_nodes, node + 1)
        return drawn

    def next_event_time(self) -> float:
        return self.events[0][0] if self.events else float("inf")

    def pop_due(self, now: float) -> list[tuple[float, str, int]]:
        due = []
        while self.events and self.events[0][0] <= now + 1e-9:
            due.append(heapq.heappop(self.events))
        return due

    def checkpointed_progress(self, elapsed: float, runtime: float) -> float:
        """Fraction of work preserved at the last checkpoint boundary."""
        if runtime <= 0:
            return 0.0
        k = int(elapsed // self.model.ckpt_interval)
        return min(1.0, k * self.model.ckpt_interval / runtime)

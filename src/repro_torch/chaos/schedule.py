"""Correlated chaos schedules: rack bursts, spot waves, storms, blackouts.

The seed-era ``FaultModel`` draws *independent* per-node Poisson failures;
real clusters fail in correlated bursts — a rack PDU trips, a spot pool is
reclaimed in one sweep, a top-of-rack switch degrades a whole row, an
entire member cluster drops off the federation.  ``ChaosSchedule`` is the
deterministic description of such events; the injectors apply them through
the engine's forced-fault entry points at rescan-window edges (the same
controller contract as ``repro_torch.scale.Autoscaler`` and
``repro_torch.lifecycle.PreemptionController``), so a chaos run is replayable
and a ``chaos=None`` run touches zero engine code paths (pinned
bit-identical by tests).

Event semantics:

- ``fail`` / ``recover``   — rack/pool burst: the node set goes down
  together (running gangs checkpoint-kill and requeue) and comes back
  together.  Builders always emit the closing ``recover`` so a burst can
  never permanently strand capacity.
- ``reclaim``              — spot-reclamation wave against a preemptible
  pool: jobs on the reclaimed nodes are *preempted* (``preempt_job`` with
  the harsher ``SPOT_RECLAMATION_COST``, per the PR-6 follow-on) instead of
  fault-killed, then the nodes leave until the paired ``recover``.
- ``slow`` / ``unslow``    — straggler storm: a node set degrades to a
  fractional speed together (checkpoint-migration rules apply as usual).
- ``blackout`` / ``restore`` — federation member outage: every up node of
  one member fails at once; routers degrade to the surviving capable set
  and queued routes retry with backoff until the member returns (see
  ``repro_torch.fed.federation``).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Iterable, Sequence

from repro_torch.lifecycle.costs import CkptCostModel

#: Harsher-than-default checkpoint economics for spot reclamation: coarser
#: checkpoint grid (more lost work) and a heavier restore, modelling a
#: reclaimed instance whose state must be rehydrated on fresh capacity.
SPOT_RECLAMATION_COST = CkptCostModel(ckpt_interval=3600.0, restore_s=600.0,
                                      per_gpu_restore_s=8.0)


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled chaos action.  ``nodes`` targets engine-level events;
    ``sku``/``count`` select the reclaimed pool for ``reclaim`` (resolved
    against live capacity at apply time); ``cluster`` addresses the
    federation member for fleet schedules."""

    time: float
    kind: str                      # fail|recover|slow|unslow|reclaim|blackout|restore
    nodes: tuple[int, ...] = ()
    cluster: int = 0
    sku: str = "any"               # reclaim: preemptible pool SKU
    count: int = 0                 # reclaim: nodes reclaimed per wave
    down_for: float = 0.0          # reclaim: outage span (recover follows)
    slowdown: float = 0.5          # slow: speed multiplier
    note: str = ""


class ChaosSchedule:
    """Deterministic, composable list of chaos events.

    Builders append matched open/close pairs (``fail``+``recover``,
    ``slow``+``unslow``, ``blackout``+``restore``) so every injected
    outage closes even when the close lands past the stream's natural end —
    mirroring the ``FaultInjector`` pair-close invariant."""

    def __init__(self) -> None:
        self.events: list[ChaosEvent] = []

    def add(self, event: ChaosEvent) -> "ChaosSchedule":
        self.events.append(event)
        return self

    def add_rack_burst(self, at: float, nodes: Iterable[int],
                       down_for: float, *, cluster: int = 0,
                       note: str = "rack-burst") -> "ChaosSchedule":
        """Correlated outage: ``nodes`` fail together at ``at`` and recover
        together ``down_for`` seconds later."""
        nodes = tuple(int(n) for n in nodes)
        self.add(ChaosEvent(at, "fail", nodes=nodes, cluster=cluster,
                            note=note))
        self.add(ChaosEvent(at + down_for, "recover", nodes=nodes,
                            cluster=cluster, note=note))
        return self

    def add_spot_wave(self, at: float, *, sku: str = "any", count: int = 1,
                      down_for: float, cluster: int = 0,
                      note: str = "spot-wave") -> "ChaosSchedule":
        """Spot-reclamation wave: ``count`` up nodes of ``sku`` (lowest ids
        first, resolved at apply time) have their jobs preempted at the
        harsher reclamation cost, then leave for ``down_for`` seconds."""
        self.add(ChaosEvent(at, "reclaim", cluster=cluster, sku=sku,
                            count=int(count), down_for=float(down_for),
                            note=note))
        return self

    def add_straggler_storm(self, at: float, nodes: Iterable[int],
                            duration: float, *, slowdown: float = 0.5,
                            cluster: int = 0,
                            note: str = "straggler-storm") -> "ChaosSchedule":
        """Correlated slowdown: ``nodes`` degrade to ``slowdown`` speed
        together for ``duration`` seconds."""
        nodes = tuple(int(n) for n in nodes)
        self.add(ChaosEvent(at, "slow", nodes=nodes, cluster=cluster,
                            slowdown=float(slowdown), note=note))
        self.add(ChaosEvent(at + duration, "unslow", nodes=nodes,
                            cluster=cluster, note=note))
        return self

    def add_blackout(self, at: float, cluster: int,
                     duration: float, *,
                     note: str = "member-blackout") -> "ChaosSchedule":
        """Federation member outage: every up node of member ``cluster``
        fails at ``at``; the member restores ``duration`` seconds later."""
        self.add(ChaosEvent(at, "blackout", cluster=cluster, note=note))
        self.add(ChaosEvent(at + duration, "restore", cluster=cluster,
                            note=note))
        return self

    def spot_waves_for_pools(self, pools, times: Sequence[float], *,
                             frac: float = 0.5, down_for: float,
                             cluster: int = 0) -> "ChaosSchedule":
        """One reclamation wave per ``times`` entry against every pool
        flagged ``preemptible`` in a ``repro_torch.scale`` pool map, reclaiming
        ``ceil(frac * max_nodes)`` nodes of the pool's SKU per wave."""
        for sku, pool in sorted(pools.items()):
            if not getattr(pool, "preemptible", False):
                continue
            count = max(1, math.ceil(frac * pool.max_nodes))
            for at in times:
                self.add_spot_wave(at, sku=sku, count=count,
                                   down_for=down_for, cluster=cluster,
                                   note=f"spot-wave:{sku}")
        return self

    def sorted_events(self) -> list[tuple[float, int, ChaosEvent]]:
        """Events as ``(time, insertion_seq, event)`` triples — the stable
        ordering the injectors consume."""
        return sorted((e.time, i, e) for i, e in enumerate(self.events))


@dataclasses.dataclass(frozen=True)
class ChaosAction:
    """One chaos event as actually applied (telemetry record)."""

    time: float
    kind: str
    cluster: int
    nodes: tuple[int, ...]
    jobs_hit: int
    note: str


class ChaosInjector:
    """Applies a ``ChaosSchedule`` to one ``SchedulerEngine`` at rescan-
    window edges (service-loop controller contract: ``control(engine, now,
    telemetry)`` once per processed window).  Spot reclamations resolve
    their node set against live capacity and queue their own paired
    ``recover`` internally, so waves self-close like every other event."""

    def __init__(self, schedule: ChaosSchedule, *,
                 reclamation_cost: CkptCostModel | None = None):
        self._queue: list[tuple[float, int, ChaosEvent]] = \
            schedule.sorted_events()
        heapq.heapify(self._queue)
        self._seq = len(self._queue)
        self.cost = reclamation_cost if reclamation_cost is not None \
            else SPOT_RECLAMATION_COST
        self.actions: list[ChaosAction] = []

    # ------------------------------------------------------------ queries ----
    def next_time(self) -> float:
        return self._queue[0][0] if self._queue else math.inf

    def action_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for a in self.actions:
            counts[a.kind] = counts.get(a.kind, 0) + 1
        return counts

    # ------------------------------------------------------------- control ----
    def _push(self, event: ChaosEvent) -> None:
        heapq.heappush(self._queue, (event.time, self._seq, event))
        self._seq += 1

    def _pop_due(self, now: float) -> list[ChaosEvent]:
        due = []
        while self._queue and self._queue[0][0] <= now + 1e-9:
            due.append(heapq.heappop(self._queue)[2])
        return due

    def control(self, engine, now: float, telemetry=None) \
            -> list[ChaosAction]:
        due = self._pop_due(now)
        if not due:
            return []
        if now > engine.now:
            engine.advance_to(now)
        applied = [self._apply(engine, e, now) for e in due]
        self.actions.extend(applied)
        if telemetry is not None:
            note = getattr(telemetry, "note_chaos_events", None)
            if note is not None:
                note(applied)
        engine.reschedule(at=now)
        return applied

    def _apply(self, engine, e: ChaosEvent, now: float) -> ChaosAction:
        hit = 0
        nodes = e.nodes
        if e.kind == "fail":
            for n in nodes:
                hit += engine.force_fail(n)
        elif e.kind == "recover":
            for n in nodes:
                engine.force_recover(n)
        elif e.kind == "slow":
            for n in nodes:
                engine.force_slow(n, e.slowdown)
        elif e.kind == "unslow":
            for n in nodes:
                engine.force_unslow(n)
        elif e.kind == "reclaim":
            nodes = self._resolve_spot_nodes(engine, e)
            for n in nodes:
                hit += engine.reclaim_node(n, self.cost)
            if nodes and e.down_for > 0:
                self._push(ChaosEvent(now + e.down_for, "recover",
                                      nodes=nodes, cluster=e.cluster,
                                      note=e.note))
        else:
            raise ValueError(
                f"chaos event kind {e.kind!r} targets the federation; "
                f"use FleetChaosInjector")
        return ChaosAction(time=now, kind=e.kind, cluster=e.cluster,
                           nodes=tuple(nodes), jobs_hit=hit, note=e.note)

    @staticmethod
    def _resolve_spot_nodes(engine, e: ChaosEvent) -> tuple[int, ...]:
        """Lowest-id up nodes matching the wave's SKU — deterministic, and
        biased toward the same pool prefix wave after wave (a realistic
        reclamation pattern: providers drain pools from one edge)."""
        cluster = engine.cluster
        up = cluster.placeable_mask()
        chosen = []
        for i in range(len(cluster.gpu_types)):
            if len(chosen) >= e.count:
                break
            if up[i] and (e.sku == "any" or str(cluster.gpu_types[i]) == e.sku):
                chosen.append(i)
        return tuple(chosen)


class FleetChaosInjector:
    """Applies a fleet ``ChaosSchedule`` across a ``FederatedScheduler``:
    engine-level events dispatch to ``fed.engines[event.cluster]`` (same
    semantics as ``ChaosInjector``), ``blackout``/``restore`` toggle whole
    members through the federation's offline-routing machinery."""

    def __init__(self, schedule: ChaosSchedule, *,
                 reclamation_cost: CkptCostModel | None = None):
        self._queue: list[tuple[float, int, ChaosEvent]] = \
            schedule.sorted_events()
        heapq.heapify(self._queue)
        self._seq = len(self._queue)
        self.cost = reclamation_cost if reclamation_cost is not None \
            else SPOT_RECLAMATION_COST
        self.actions: list[ChaosAction] = []

    def next_time(self) -> float:
        return self._queue[0][0] if self._queue else math.inf

    def action_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for a in self.actions:
            counts[a.kind] = counts.get(a.kind, 0) + 1
        return counts

    def _push(self, event: ChaosEvent) -> None:
        heapq.heappush(self._queue, (event.time, self._seq, event))
        self._seq += 1

    def control(self, fed, now: float) -> list[ChaosAction]:
        due = []
        while self._queue and self._queue[0][0] <= now + 1e-9:
            due.append(heapq.heappop(self._queue)[2])
        if not due:
            return []
        applied = []
        touched: set[int] = set()
        for e in due:
            if e.kind == "blackout":
                downed = fed.blackout_member(e.cluster, at=now)
                applied.append(ChaosAction(
                    time=now, kind=e.kind, cluster=e.cluster,
                    nodes=tuple(downed), jobs_hit=len(downed), note=e.note))
            elif e.kind == "restore":
                restored = fed.restore_member(e.cluster, at=now)
                applied.append(ChaosAction(
                    time=now, kind=e.kind, cluster=e.cluster,
                    nodes=tuple(restored), jobs_hit=len(restored),
                    note=e.note))
            else:
                eng = fed.engines[e.cluster]
                if now > eng.now:
                    eng.advance_to(now)
                sub = ChaosInjector.__new__(ChaosInjector)
                sub._queue, sub._seq, sub.cost, sub.actions = \
                    [], 0, self.cost, []
                act = sub._apply(eng, e, now)
                # a reclaim's paired recover lands back on *this* queue
                for (t, _, follow) in sub._queue:
                    self._push(dataclasses.replace(follow, cluster=e.cluster))
                applied.append(dataclasses.replace(act, cluster=e.cluster))
                touched.add(e.cluster)
        for idx in sorted(touched):
            fed.engines[idx].reschedule(at=now)
        fed.note_chaos(applied, now)
        self.actions.extend(applied)
        return applied

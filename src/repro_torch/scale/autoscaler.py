"""Telemetry-driven autoscaling controllers (elastic cluster capacity).

The scheduler so far only reordered a queue against *fixed* capacity; this
module closes the loop the ROADMAP calls for: rolling telemetry (utilization
timeline, wait-p99) drives node add/remove events consumed by the
rescan-interval service loop.  The design follows the survey observation
(Gao et al., "Deep Learning Workload Scheduling in GPU Datacenters") that
elastic capacity is the lever queue-ordering schedulers leave on the table —
and the source paper's utilization objective is exactly the controller
input our rolling telemetry already computes.

Mechanics
---------
A controller manages **per-SKU pools** (``PoolSpec``: node template plus
min/max node bounds) and, once per processed rescan window, reads the
engine's ``EngineSnapshot`` and — when attached — ``RollingTelemetry``, then
emits at most one scaling action subject to:

- **hysteresis**: two thresholds (band / dual watermark) so the signal must
  cross distinct levels to scale up vs. down — no flapping on noise;
- **cooldown**: a minimum simulated-time gap between actions;
- **bounds**: per-pool min/max active node counts.

Scale-up re-admits a draining (cordoned) node of the target SKU before
paying for a fresh one; scale-down prefers idle nodes and otherwise cordons
the least-busy node, which the cluster auto-retires once it drains (see
``ClusterState`` drain semantics).  Every action is logged as a
``ScaleEvent`` and forwarded to telemetry for provisioning-cost accounting.

A **stall override** lets the service loop force a scale-up evaluation
(ignoring cooldown and the signal) when the queue is starved and the event
heap has run dry — without it, a too-aggressive scale-down could strand
pending jobs forever.  The override still respects pool max bounds, so a
genuinely unplaceable job terminates the run instead of looping.

Controllers hold no reference to cluster internals beyond the public
``ClusterState`` arrays and mutators; with ``autoscaler=None`` every code
path in the engine/service is bit-identical to the pre-autoscaling system
(pinned by tests).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.types import ClusterSpec, NodeSpec


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    """One capacity action taken by a controller."""

    time: float
    action: str          # "add" | "uncordon" | "cordon" | "retire"
    node_id: int
    gpu_type: str
    reason: str


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """One elastic per-SKU pool: the node template scale-up clones and the
    active-node bounds the controller must respect.  ``preemptible`` marks
    the pool as spot capacity — cheap but reclaimable: ``repro_torch.chaos`` spot-
    reclamation waves (``ChaosSchedule.spot_waves_for_pools``) target only
    pools that opt in."""

    gpu_type: str
    template: NodeSpec
    min_nodes: int
    max_nodes: int
    preemptible: bool = False


def pools_from_spec(spec: ClusterSpec, *, min_frac: float = 0.25,
                    max_frac: float = 1.0) -> dict[str, PoolSpec]:
    """Derive per-SKU pools from a cluster spec: the template is the SKU's
    first node, ``min_nodes = max(1, ceil(min_frac * count))`` and
    ``max_nodes = max(count, ceil(max_frac * count))`` — with the defaults a
    controller may shrink to a quarter of each pool but never grow past the
    provisioned peak (the static-capacity baseline)."""
    by_sku: dict[str, list[NodeSpec]] = {}
    for nd in spec.nodes:
        by_sku.setdefault(nd.gpu_type, []).append(nd)
    pools = {}
    for sku, nodes in by_sku.items():
        count = len(nodes)
        pools[sku] = PoolSpec(
            gpu_type=sku, template=nodes[0],
            min_nodes=max(1, math.ceil(min_frac * count)),
            max_nodes=max(count, math.ceil(max_frac * count)))
    return pools


class Autoscaler:
    """Base controller: pool bookkeeping, hysteresis plumbing, cooldown,
    bounds, and the add/uncordon/cordon action mechanics.  Subclasses
    implement :meth:`desired_direction`."""

    name = "base"

    def __init__(self, pools: dict[str, PoolSpec], *,
                 cooldown_s: float = 1800.0, step_nodes: int = 1):
        if not pools:
            raise ValueError("an autoscaler needs at least one pool")
        self.pools = dict(pools)
        self.cooldown_s = cooldown_s
        self.step_nodes = max(1, int(step_nodes))
        self.events: list[ScaleEvent] = []
        self._last_action_t = -math.inf

    @classmethod
    def from_spec(cls, spec: ClusterSpec, *, min_frac: float = 0.25,
                  max_frac: float = 1.0, **kw) -> "Autoscaler":
        return cls(pools_from_spec(spec, min_frac=min_frac,
                                   max_frac=max_frac), **kw)

    # ------------------------------------------------------------ subclass API --
    def desired_direction(self, engine, now: float,
                          telemetry) -> tuple[int, str]:
        """``(direction, reason)``: +1 scale up, -1 scale down, 0 hold."""
        raise NotImplementedError

    # --------------------------------------------------------------- control ----
    def control(self, engine, now: float, telemetry=None,
                stalled: bool = False) -> list[ScaleEvent]:
        """One controller tick.  Reads signals, maybe emits one bounded
        action, applies it to ``engine.cluster``, and kicks the engine so a
        newly feasible queue schedules immediately.  ``stalled=True`` is
        the service loop's starvation override: force a scale-up attempt
        regardless of cooldown or signal."""
        if stalled:
            direction, reason = 1, "stall: pending jobs with no feasible event"
        elif now - self._last_action_t < self.cooldown_s:
            return []
        else:
            direction, reason = self.desired_direction(engine, now, telemetry)
        if direction == 0:
            return []
        if direction > 0:
            events = self._scale_up(engine, now, reason)
        else:
            events = self._scale_down(engine, now, reason)
        if events:
            self._last_action_t = now
            self.events.extend(events)
            if telemetry is not None:
                telemetry.note_scale_events(events)
            engine.reschedule(at=now)
        return events

    # -------------------------------------------------------------- forecast ----
    def _forecast_gpu_hours(self, engine) -> float | None:
        """Predicted GPU-hours of the pending window, when the engine carries
        an assisting runtime predictor (``repro_torch.predict``).  ``None`` when no
        predictor is attached or it runs in shadow mode — controllers must
        then fall back to their reactive signals, keeping the predictor-off
        path bit-identical."""
        pred = getattr(engine, "predictor", None)
        if pred is None or not getattr(pred, "assist", False):
            return None
        fn = getattr(pred, "pending_gpu_hours", None)
        if fn is None:
            return None
        return float(fn(engine))

    # ------------------------------------------------------------- pool state ---
    def _active_count(self, cluster, sku: str) -> int:
        """Nodes of the pool the bounds govern: not retired, not draining
        (down-but-repairing nodes still count — they come back)."""
        m = cluster.sku_mask(sku)
        return int((m & ~cluster.retired & ~cluster.cordoned).sum())

    def _pending_demand(self, engine, cap: int = 512) -> dict[str, int]:
        """Pending GPU demand per SKU over the queue head (bounded scan);
        flexible ("any") demand is credited to every pool."""
        demand: dict[str, int] = {sku: 0 for sku in self.pools}
        for j in engine.pending[:cap]:
            if j.gpu_type == "any":
                for sku in demand:
                    demand[sku] += j.num_gpus
            elif j.gpu_type in demand:
                demand[j.gpu_type] += j.num_gpus
        return demand

    def _pools_by_up_preference(self, engine) -> list[str]:
        """Pools ordered by scale-up priority: unmet pending demand first,
        then per-SKU busy fraction; deterministic tie-break on SKU name."""
        cluster = engine.cluster
        demand = self._pending_demand(engine)
        _, free_by_type = cluster.free_gpu_tallies()
        _, prov_by_type = cluster.provisioned_gpu_totals()

        def busy_frac(sku: str) -> float:
            prov = prov_by_type.get(sku, 0)
            return 1.0 - free_by_type.get(sku, 0) / prov if prov else 0.0

        return sorted(self.pools,
                      key=lambda sku: (-demand.get(sku, 0),
                                       -busy_frac(sku), sku))

    def _scale_up(self, engine, now: float, reason: str) -> list[ScaleEvent]:
        cluster = engine.cluster
        events: list[ScaleEvent] = []
        order = self._pools_by_up_preference(engine)
        for _ in range(self.step_nodes):
            sku = next((s for s in order
                        if self._active_count(cluster, s)
                        < self.pools[s].max_nodes), None)
            if sku is None:
                break
            pool = self.pools[sku]
            # re-admit a draining node before paying for a fresh one
            cand = np.flatnonzero(cluster.sku_mask(sku) & cluster.cordoned)
            if cand.size:
                nid = int(cand[0])
                cluster.uncordon_node(nid)
                events.append(ScaleEvent(now, "uncordon", nid, sku, reason))
            else:
                nid = cluster.add_node(pool.template)
                events.append(ScaleEvent(now, "add", nid, sku, reason))
        return events

    def _scale_down(self, engine, now: float, reason: str) -> list[ScaleEvent]:
        cluster = engine.cluster
        events: list[ScaleEvent] = []
        for _ in range(self.step_nodes):
            # pool with the most idle placeable GPUs sheds first
            placeable = cluster.placeable_mask()
            best, best_idle = None, -1
            for sku, pool in sorted(self.pools.items()):
                if self._active_count(cluster, sku) <= pool.min_nodes:
                    continue
                idle = int(cluster.free_gpus[cluster.sku_mask(sku)
                                             & placeable].sum())
                if idle > best_idle:
                    best, best_idle = sku, idle
            if best is None:
                break
            m = cluster.sku_mask(best) & ~cluster.retired & ~cluster.cordoned
            cand = np.flatnonzero(m)
            # least busy first; ties retire the newest node
            busy = (cluster.total_gpus[cand] - cluster.free_gpus[cand])
            nid = int(cand[np.lexsort((-cand, busy))[0]])
            retired = cluster.remove_node(nid)
            events.append(ScaleEvent(now, "retire" if retired else "cordon",
                                     nid, best, reason))
        return events

    # ------------------------------------------------------------- reporting ----
    def event_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for e in self.events:
            counts[e.action] = counts.get(e.action, 0) + 1
        return counts


class TargetUtilizationAutoscaler(Autoscaler):
    """Keep rolling GPU utilization inside ``[util_low, util_high]``: above
    the band adds capacity, below it (with an empty-enough queue) drains
    capacity.  The band *is* the hysteresis — the two watermarks must be
    separated for the controller to hold steady between them."""

    name = "target-util"

    def __init__(self, pools: dict[str, PoolSpec], *,
                 util_low: float = 0.35, util_high: float = 0.85,
                 max_pending_for_down: int = 0,
                 forecast_hold_gpu_hours: float = 8.0, **kw):
        if not 0.0 <= util_low < util_high <= 1.0:
            raise ValueError(f"need 0 <= util_low < util_high <= 1, got "
                             f"[{util_low}, {util_high}]")
        super().__init__(pools, **kw)
        self.util_low = util_low
        self.util_high = util_high
        self.max_pending_for_down = max_pending_for_down
        self.forecast_hold_gpu_hours = forecast_hold_gpu_hours

    def desired_direction(self, engine, now, telemetry) -> tuple[int, str]:
        snap = engine.snapshot()
        if telemetry is not None:
            util = telemetry.probe(now, engine).utilization
            src = "rolling"
        else:
            util = snap.utilization
            src = "instant"
        if util > self.util_high:
            return 1, f"{src} util {util:.2f} > {self.util_high:.2f}"
        if util < self.util_low and snap.num_pending <= self.max_pending_for_down:
            # predicted demand holds capacity that instantaneous utilization
            # would drain — the forecast sees pending work the utilization
            # signal has not absorbed yet
            fc = self._forecast_gpu_hours(engine)
            if fc is not None and fc >= self.forecast_hold_gpu_hours:
                return 0, (f"hold: forecast {fc:.1f} GPU-h >= "
                           f"{self.forecast_hold_gpu_hours:.1f}")
            return -1, f"{src} util {util:.2f} < {self.util_low:.2f}"
        return 0, "in band"


class QueuePressureAutoscaler(Autoscaler):
    """Scale on queueing delay: rolling wait-p99 above ``wait_up_s`` adds
    capacity; wait-p99 below ``wait_down_s`` with an idle-enough cluster
    drains it.  The dual watermark (``wait_down_s`` well under
    ``wait_up_s``) is the hysteresis."""

    name = "queue-pressure"

    def __init__(self, pools: dict[str, PoolSpec], *,
                 wait_up_s: float = 1800.0, wait_down_s: float = 300.0,
                 util_down: float = 0.5,
                 forecast_up_gpu_hours: float = 64.0, **kw):
        if not 0.0 <= wait_down_s < wait_up_s:
            raise ValueError(f"need 0 <= wait_down_s < wait_up_s, got "
                             f"[{wait_down_s}, {wait_up_s}]")
        super().__init__(pools, **kw)
        self.wait_up_s = wait_up_s
        self.wait_down_s = wait_down_s
        self.util_down = util_down
        self.forecast_up_gpu_hours = forecast_up_gpu_hours

    def desired_direction(self, engine, now, telemetry) -> tuple[int, str]:
        snap = engine.snapshot()
        if telemetry is not None:
            sample = telemetry.probe(now, engine)
            wait_p99, util = sample.wait_p99, sample.utilization
        else:
            wait_p99, util = 0.0, snap.utilization
        if wait_p99 > self.wait_up_s:
            return 1, f"wait p99 {wait_p99:.0f}s > {self.wait_up_s:.0f}s"
        if snap.num_pending > 0:
            # forecast lead: predicted backlog GPU-hours trip the up
            # watermark before the rolling wait percentile reacts
            fc = self._forecast_gpu_hours(engine)
            if fc is not None and fc >= self.forecast_up_gpu_hours:
                return 1, (f"forecast {fc:.1f} GPU-h >= "
                           f"{self.forecast_up_gpu_hours:.1f}")
        if snap.num_pending > 0 and snap.free_gpus == 0:
            # backlog against a fully busy cluster: do not wait for the
            # rolling percentile to catch up
            return 1, "backlog with zero free GPUs"
        if wait_p99 < self.wait_down_s and snap.num_pending == 0 \
                and util < self.util_down:
            return -1, f"wait p99 {wait_p99:.0f}s < {self.wait_down_s:.0f}s"
        return 0, "between watermarks"


AUTOSCALERS: dict[str, type] = {
    "target-util": TargetUtilizationAutoscaler,
    "queue-pressure": QueuePressureAutoscaler,
}


def make_autoscaler(name: str, spec: ClusterSpec, **kw) -> Autoscaler:
    """Build a registered controller with pools derived from ``spec``.
    ``min_frac``/``max_frac`` pass through to :func:`pools_from_spec`;
    everything else goes to the controller."""
    if name not in AUTOSCALERS:
        raise KeyError(f"unknown autoscaler {name!r}; "
                       f"registered: {', '.join(sorted(AUTOSCALERS))}")
    pool_kw = {k: kw.pop(k) for k in ("min_frac", "max_frac") if k in kw}
    return AUTOSCALERS[name](pools_from_spec(spec, **pool_kw), **kw)


def list_autoscalers() -> list[str]:
    return sorted(AUTOSCALERS)

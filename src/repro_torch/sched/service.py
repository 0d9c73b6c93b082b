"""Rescan-interval service driver over the streaming engine.

Replays a job stream (or a registered scenario) through ``SchedulerEngine``
the way the paper's Slurm integration runs RLTune (Sec. 3.1.2): wall-clock
advances in ``rescan_interval`` windows; newly arrived jobs are submitted as
their window opens, the engine steps to the window edge, and telemetry rolls
continuously.  Works with any ``Prioritizer`` — including
``repro_torch.core.live.LivePrioritizer`` (the `scontrol update priority=` path),
which is how ``run_live`` routes through this module.

Because scheduling decisions only happen at event instants, windowed
stepping is *exactly* equivalent to one ``drain()`` over the same jobs; the
window boundaries are where a real deployment would poll the queue, attach
autoscalers, or checkpoint the service.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

from repro_torch.core.faults import FaultModel
from repro_torch.core.metrics import BatchResult
from repro_torch.core.policies import make_policy
from repro_torch.core.types import ClusterSpec, Job
from repro_torch.sched.engine import (DEFAULT_QUEUE_WINDOW, EngineHooks,
                                MultiHooks, PolicyPrioritizer, Prioritizer,
                                SchedulerEngine)
from repro_torch.sched.scenarios import Scenario, ScenarioRun, get_scenario
from repro_torch.sched.telemetry import RollingTelemetry


@dataclasses.dataclass
class StreamResult:
    """Outcome of replaying a stream through the engine."""

    batch: BatchResult                   # aggregate metrics (repro_torch.core)
    telemetry: RollingTelemetry | None
    windows: int                         # rescan windows processed
    engine: SchedulerEngine
    obs: object | None = None            # repro_torch.obs.Observability, if armed


def _controller_tick(obs, kind: str, now: float, fn):
    """Run one controller tick; with an ``Observability`` bundle armed,
    wall-clock the tick and record it as a control-plane span plus
    tick/action counters.  ``obs=None`` calls ``fn`` directly."""
    if obs is None:
        return fn()
    t0 = time.perf_counter()
    events = fn()
    try:
        n = len(events)
    except TypeError:
        n = int(bool(events))
    obs.note_controller(kind, n, time.perf_counter() - t0, now)
    return events


class SlaLanePrioritizer:
    """Generic SLA bypass lane (Sec. 3.1.2) over any base prioritizer:
    SLA-bound users' jobs schedule first, ranked FCFS among themselves.

    Exposes ``rank_window`` so the engine's incrementally-maintained field
    arrays survive the wrapper: the non-SLA partition is handed to the base
    as a row-subset ``WindowFields`` instead of forcing the base back onto
    per-job attribute gathering (must rank identically to ``rank``)."""

    def __init__(self, base: Prioritizer, sla_users: frozenset[int]):
        self.base = base
        self.sla_users = sla_users
        self.use_estimates = base.use_estimates
        self._base_rank_window = getattr(base, "rank_window", None)

    def _split(self, jobs):
        sla = [i for i, j in enumerate(jobs) if j.user in self.sla_users]
        rest = [i for i, j in enumerate(jobs) if j.user not in self.sla_users]
        sla.sort(key=lambda i: (jobs[i].submit_time, jobs[i].job_id))
        return sla, rest

    def rank(self, jobs, cluster, now):
        sla, rest = self._split(jobs)
        sub = self.base.rank([jobs[i] for i in rest], cluster, now)
        return sla + [rest[i] for i in sub]

    def rank_window(self, jobs, cluster, now, fields):
        sla, rest = self._split(jobs)
        if self._base_rank_window is not None and fields is not None:
            sub = self._base_rank_window([jobs[i] for i in rest], cluster,
                                         now, fields.take(rest))
        else:
            sub = self.base.rank([jobs[i] for i in rest], cluster, now)
        return sla + [rest[i] for i in sub]

    def observe_finish(self, job):
        self.base.observe_finish(job)


class QuotaPrioritizer(EngineHooks):
    """Multi-tenant VC quotas over any base prioritizer: jobs belonging to a
    VC whose running GPU share already exceeds its quota are demoted behind
    all under-quota jobs (weighted-fair-share gate, not preemption).

    Per-VC running GPU usage is maintained **incrementally**: the driver
    attaches the prioritizer as an engine hook, so every job start / finish /
    fault-requeue transition updates one dict entry (O(1)) instead of the
    former O(running) recompute on every ``rank`` call.
    ``incremental=False`` retains that recompute (reading
    ``self.engine.running``) as the differential reference path — both must
    gate identically."""

    def __init__(self, base: Prioritizer, quotas: dict[int, float],
                 incremental: bool = True):
        self.base = base
        self.quotas = quotas
        self.use_estimates = base.use_estimates
        self.incremental = incremental
        self.engine: SchedulerEngine | None = None   # attached by the driver
        self._usage: dict[int, int] = {}   # vc -> running GPUs (hook-fed)
        self._base_rank_window = getattr(base, "rank_window", None)

    # -- EngineHooks: usage tracks exactly the engine's running set ----------
    def on_start(self, job, now):
        self._usage[job.vc] = self._usage.get(job.vc, 0) + job.num_gpus

    def on_finish(self, job, now):
        self._drop(job)

    def on_requeue(self, job, now):
        self._drop(job)

    def _drop(self, job):
        left = self._usage.get(job.vc, 0) - job.num_gpus
        if left > 0:
            self._usage[job.vc] = left
        else:
            self._usage.pop(job.vc, None)

    def reset_usage(self) -> None:
        """Clear hook-fed usage (drivers call this before attaching to a
        fresh, idle engine so a reused prioritizer can't carry stale state)."""
        self._usage.clear()

    def _vc_usage(self) -> dict[int, int]:
        if self.incremental:
            return self._usage
        used: dict[int, int] = {}
        if self.engine is not None:
            for job, *_ in self.engine.running.values():
                used[job.vc] = used.get(job.vc, 0) + job.num_gpus
        return used

    def _gate(self, jobs, cluster, order):
        used = self._vc_usage()
        # provisioned (non-retired) capacity: VC shares must track elastic
        # cluster size, and equal the raw total whenever autoscaling is off
        total = max(cluster.provisioned_gpu_totals()[0], 1)
        over = {vc for vc, q in self.quotas.items()
                if used.get(vc, 0) / total > q}
        under = [i for i in order if jobs[i].vc not in over]
        demoted = [i for i in order if jobs[i].vc in over]
        return under + demoted

    def rank(self, jobs, cluster, now):
        return self._gate(jobs, cluster, self.base.rank(jobs, cluster, now))

    def rank_window(self, jobs, cluster, now, fields):
        """Full-window field pass-through to the base (the quota gate itself
        is a stable partition of the base order, so gating the fields-path
        ranking is bit-identical to gating ``base.rank``)."""
        if self._base_rank_window is not None and fields is not None:
            order = self._base_rank_window(jobs, cluster, now, fields)
        else:
            order = self.base.rank(jobs, cluster, now)
        return self._gate(jobs, cluster, order)

    def observe_finish(self, job):
        self.base.observe_finish(job)


def wrap_tenancy(pri: Prioritizer, sla_users: frozenset[int] = frozenset(),
                 vc_quotas: dict[int, float] | None = None,
                 enforce_quotas: bool = True) -> Prioritizer:
    """Wrap a base prioritizer with the SLA bypass lane and/or VC-quota gate
    a workload's tenant metadata calls for (shared by ``run_scenario`` and
    the federation layer so both wire tenancy identically)."""
    if sla_users:
        pri = SlaLanePrioritizer(pri, sla_users)
    if vc_quotas and enforce_quotas:
        pri = QuotaPrioritizer(pri, vc_quotas)
    return pri


# ----------------------------------------------------------------- drivers ----


def run_stream(
    spec: ClusterSpec,
    jobs: list[Job],
    prioritizer: Prioritizer,
    *,
    rescan_interval: float = 60.0,
    allocator: str = "milp",
    backfill: bool = True,
    lookahead_k: int = 8,
    fault_model: FaultModel | None = None,
    queue_window: int = DEFAULT_QUEUE_WINDOW,
    telemetry: RollingTelemetry | None = None,
    chunked_submit: bool = False,
    hooks: tuple[EngineHooks, ...] = (),
    optimized: bool = True,
    on_window: "Callable[[SchedulerEngine, float, int], None] | None" = None,
    autoscaler=None,
    preemption=None,
    chaos=None,
    degradation=None,
    obs=None,
    predictor=None,
) -> StreamResult:
    """Replay ``jobs`` through a fresh engine in rescan-interval windows.

    With ``chunked_submit`` the driver feeds each window's arrivals right
    before stepping past them (true streaming ingestion); otherwise the whole
    stream is registered upfront (identical schedule either way — arrivals
    only take effect at their event instant).

    ``on_window(engine, window_edge, windows)`` fires after every *processed*
    rescan window (hopped-over empty windows don't fire) — the streaming RL
    trainer uses it to cut fixed-horizon episodes at window boundaries.  The
    callback must not mutate engine state.

    ``autoscaler`` (a ``repro_torch.scale.Autoscaler``) gets one control tick per
    processed window — exactly where a real deployment would attach it — and
    a forced *stall* tick whenever the queue is starved with a dry event
    heap (capacity, not ordering, is then the blocker; see
    ``Autoscaler.control``).  ``autoscaler=None`` leaves every engine code
    path bit-identical to the pre-autoscaling service (pinned by tests).

    ``preemption`` (a ``repro_torch.lifecycle.PreemptionController``) ticks once
    per processed window, *after* the autoscaler — lifecycle moves act on
    the post-scaling cluster.  ``preemption=None`` likewise touches no
    engine code path (pinned bit-identical by tests).

    ``chaos`` (a ``repro_torch.chaos.ChaosInjector``) ticks *first* each
    processed window — injected outages land before any controller reacts,
    the order a real incident unfolds in — and its due times join the
    window-hop bound so a burst scheduled in an otherwise-quiet stretch is
    not skipped over.  ``degradation`` (a ``repro_torch.chaos.DegradationPolicy``)
    arms the engine's control-plane degradation ladder.  Both default to
    ``None``: bit-identical to the pre-chaos service (pinned by tests).

    ``obs`` (a ``repro_torch.obs.Observability``) attaches the tracing / metrics /
    audit sinks and wall-clocks every controller tick into the control-plane
    trace.  ``obs=None`` leaves the schedule bit-identical (pinned).

    ``predictor`` (a ``repro_torch.predict.RuntimePredictor``) trains online from
    completion hooks and — when ``assist=True`` — gates EASY backfill on
    predicted p90, feeds MILP lookahead durations, and serves autoscaler
    demand forecasts.  ``predictor=None`` *and* a shadow predictor
    (``assist=False``) are pinned bit-identical (tested).

    All observers — user ``hooks``, telemetry, obs sinks, and the
    incremental quota gate — are composed through one ``MultiHooks``, so a
    duck-typed partial hook object receives exactly the events it defines
    (the full ``EngineHooks`` surface, ``on_preempt`` / ``on_resume`` /
    ``on_decision`` / ``on_tick`` included) and a raising observer is
    isolated instead of corrupting the window mid-schedule.
    """
    if autoscaler is not None:
        # scale-ups append to spec.nodes: give the engine its own copy so a
        # caller-held ScenarioRun/spec can be replayed (e.g. static-vs-
        # autoscaled comparisons) without seeing grown capacity
        spec = ClusterSpec(nodes=list(spec.nodes), name=spec.name)
    children = list(hooks)
    if telemetry is not None:
        children.append(telemetry)
    if obs is not None:
        children.extend(obs.hooks())
    if predictor is not None:
        # hook-trained: on_submit caches features, on_finish does one SGD
        # step — shadow (assist=False) predictors observe without steering
        children.append(predictor)
    if isinstance(prioritizer, QuotaPrioritizer) and prioritizer.incremental:
        # hook-fed per-VC usage: the engine starts idle, so start from zero
        prioritizer.reset_usage()
        children.append(prioritizer)
    all_hooks = (MultiHooks(*children),) if children else ()
    engine = SchedulerEngine(
        spec, prioritizer, allocator=allocator, backfill=backfill,
        lookahead_k=lookahead_k, fault_model=fault_model,
        queue_window=queue_window, hooks=all_hooks, optimized=optimized,
        degradation=degradation, predictor=predictor)
    if isinstance(prioritizer, QuotaPrioritizer):
        prioritizer.engine = engine

    jobs = sorted(jobs, key=lambda j: j.submit_time)
    feed = 0
    if not chunked_submit:
        engine.submit(jobs)
        feed = len(jobs)

    iv = max(rescan_interval, 1e-6)
    t0 = jobs[0].submit_time if jobs else 0.0
    t = t0
    windows = 0
    while True:
        # feed the arrivals due in the upcoming window
        hi = feed
        while hi < len(jobs) and jobs[hi].submit_time <= t + iv:
            hi += 1
        if hi > feed:
            engine.submit(jobs[feed:hi])
            feed = hi
        if feed >= len(jobs) and (engine.done
                                  or engine.next_event_time() == math.inf):
            if not engine.done and chaos is not None \
                    and chaos.next_time() < math.inf:
                # dry heap with queued jobs: only a chaos event (e.g. the
                # recover closing a burst that took the last capable nodes)
                # can unblock them — hop to its window edge and tick
                t = t0 + math.ceil((chaos.next_time() - t0) / iv) * iv
                engine.step(t)
                _controller_tick(obs, "chaos", t,
                                 lambda t=t: chaos.control(engine, t,
                                                           telemetry))
                continue
            if engine.done or autoscaler is None:
                break
            # starved queue with a dry heap: jobs are pending but no event
            # can ever schedule them — only added capacity can.  Force a
            # stall-override control tick; if the controller cannot act
            # (every pool at its max bound) the job is genuinely
            # unplaceable and the stream ends incomplete.
            t += iv
            acted = _controller_tick(
                obs, "autoscaler", t,
                lambda t=t: autoscaler.control(engine, t, telemetry,
                                               stalled=True))
            if not acted and engine.next_event_time() == math.inf:
                break
            continue
        nxt = engine.next_event_time()
        if feed < len(jobs):
            nxt = min(nxt, jobs[feed].submit_time)
        if chaos is not None:
            nxt = min(nxt, chaos.next_time())
        if nxt > t + iv:
            # nothing due for a while: hop empty windows in one grid-aligned
            # jump, then re-run the feed so arrivals due in the hopped-to
            # window are submitted before any queued event beyond them runs
            t = t0 + math.floor((nxt - t0) / iv) * iv
            continue
        t_step = time.perf_counter() if obs is not None else 0.0
        processed = engine.step(t + iv)
        t += iv
        windows += 1
        if obs is not None:
            obs.note_window(t, time.perf_counter() - t_step, processed)
        if chaos is not None:
            _controller_tick(obs, "chaos", t,
                             lambda t=t: chaos.control(engine, t, telemetry))
        if autoscaler is not None:
            _controller_tick(obs, "autoscaler", t,
                             lambda t=t: autoscaler.control(engine, t,
                                                            telemetry))
        if preemption is not None:
            _controller_tick(obs, "preemption", t,
                             lambda t=t: preemption.control(engine, t,
                                                            telemetry))
        if on_window is not None:
            on_window(engine, t, windows)
    if telemetry is not None:
        telemetry.final(engine)
    if obs is not None:
        obs.finalize(engine)
    return StreamResult(batch=engine.result(), telemetry=telemetry,
                        windows=windows, engine=engine, obs=obs)


def run_scenario(
    scenario: str | Scenario | ScenarioRun,
    num_jobs: int = 1000,
    seed: int = 0,
    *,
    prioritizer: Prioritizer | None = None,
    rescan_interval: float = 60.0,
    allocator: str = "milp",
    backfill: bool = True,
    queue_window: int = DEFAULT_QUEUE_WINDOW,
    telemetry_window: float = 6 * 3600.0,
    sample_interval: float = 600.0,
    enforce_quotas: bool = True,
    autoscaler=None,
    preemption=None,
    chaos=None,
    degradation=None,
    obs=None,
    predictor=None,
) -> StreamResult:
    """Build a registered scenario and stream it through the engine with
    rolling telemetry.  The scenario's SLA population and VC quotas are
    honoured by wrapping the prioritizer with the matching lane/gate.
    ``autoscaler`` attaches a ``repro_torch.scale`` controller to the service
    loop (one control tick per processed rescan window); ``preemption``
    attaches a ``repro_torch.lifecycle`` controller ticking right after it.

    ``chaos`` selects the fault-injection layer: ``None`` (default) wraps
    the scenario's own ``ChaosSchedule`` (if it declares one) in a fresh
    ``ChaosInjector``; ``False`` forces chaos off even for chaos scenarios
    (the benchmark's chaos-off arm); anything else is used as the injector
    directly.  ``degradation`` arms the engine's degradation ladder."""
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    run = scenario.build(num_jobs, seed) if isinstance(scenario, Scenario) \
        else scenario
    pri = prioritizer or PolicyPrioritizer(make_policy("fcfs"))
    pri = wrap_tenancy(pri, run.sla_users, run.vc_quotas,
                       enforce_quotas=enforce_quotas)
    telemetry = RollingTelemetry(window=telemetry_window,
                                 sample_interval=sample_interval)
    run_chaos = getattr(run, "chaos", None)
    if chaos is None and run_chaos is not None:
        from repro_torch.chaos import ChaosInjector
        chaos = ChaosInjector(run_chaos)
    elif chaos is False:
        chaos = None
    return run_stream(
        run.spec, [j.clone_pending() for j in run.jobs], pri,
        rescan_interval=rescan_interval, allocator=allocator,
        backfill=backfill, fault_model=run.fault_model,
        queue_window=queue_window, telemetry=telemetry, chunked_submit=True,
        autoscaler=autoscaler, preemption=preemption, chaos=chaos,
        degradation=degradation, obs=obs, predictor=predictor)

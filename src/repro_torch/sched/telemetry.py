"""Rolling-window telemetry for the streaming scheduler engine.

The paper evaluates batch-aggregate metrics (Sec. 4.4); a continuously
running service instead needs *windowed* views: JCT / queueing-delay
percentiles over the trailing window, a GPU-utilization timeline, and
per-VC fairness — all without perturbing the schedule.  ``RollingTelemetry``
implements the ``EngineHooks`` observer interface: the engine calls it on
job start/finish/requeue and once per processed event batch; samples are
emitted every ``sample_interval`` seconds of *simulated* time.

Utilization is integrated exactly between event batches (busy-GPU fraction
is piecewise-constant in a discrete-event simulation), so the timeline is
not subject to sampling aliasing.

Storage is numpy ring buffers (``_Ring``): the engine clock is monotone, so
every per-event record appends at the tail in nondecreasing time order and
window eviction is one ``searchsorted`` head advance instead of a Python
pop loop — ``on_tick`` is O(1) amortized at million-event streams.  Sample
computation reads contiguous column views: one multi-q ``np.percentile``
per metric, sequential-``cumsum`` utilization integration, and a
``bincount`` per-VC share accumulation — each arithmetically identical
(same float64 operations in the same order) to the scalar loops they
replaced, pinned by ``tests/test_telemetry.py``.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.core.types import Job

# (finish_time, jct, wait, vc, gpu_seconds) per finished job — the record
# view `_FinRing` yields when iterated
_FinRec = collections.namedtuple("_FinRec", "t jct wait vc gpu_seconds")


class _Ring:
    """Append-only numpy ring with head eviction over parallel columns.

    All columns share one live region ``[head:tail)``.  Appends write at
    the tail; eviction advances the head by one ``searchsorted`` over a
    time column (append order is nondecreasing in time — the engine clock
    is monotone).  On overflow the buffer compacts in place when at least
    half is dead, else doubles — O(1) amortized per append."""

    __slots__ = ("cols", "head", "tail", "_cap")

    def __init__(self, ncols: int, cap: int = 512):
        self._cap = cap
        self.cols = [np.empty(cap, dtype=np.float64) for _ in range(ncols)]
        self.head = 0
        self.tail = 0

    def __len__(self) -> int:
        return self.tail - self.head

    def append(self, *vals: float) -> None:
        if self.tail == self._cap:
            n = self.tail - self.head
            if self.head > self._cap // 2:
                for a in self.cols:
                    a[:n] = a[self.head:self.tail]
            else:
                self._cap *= 2
                for i, a in enumerate(self.cols):
                    g = np.empty(self._cap, dtype=np.float64)
                    g[:n] = a[self.head:self.tail]
                    self.cols[i] = g
            self.head, self.tail = 0, n
        t = self.tail
        for a, v in zip(self.cols, vals):
            a[t] = v
        self.tail = t + 1

    def view(self, col: int) -> np.ndarray:
        return self.cols[col][self.head:self.tail]

    def evict_lt(self, col: int, lo: float) -> None:
        """Drop leading rows with ``cols[col] < lo`` (deque ``popleft``
        while-first-older semantics, vectorized)."""
        a = self.cols[col]
        self.head += int(np.searchsorted(a[self.head:self.tail], lo,
                                         side="left"))

    def evict_le(self, col: int, lo: float) -> None:
        """Drop leading rows with ``cols[col] <= lo``."""
        a = self.cols[col]
        self.head += int(np.searchsorted(a[self.head:self.tail], lo,
                                         side="right"))


class _FinRing(_Ring):
    """Finished-job ring (t, jct, wait, vc, gpu_seconds) that iterates as
    ``_FinRec`` records for observers/tests that walk it."""

    def __init__(self):
        super().__init__(5)

    def __iter__(self):
        for i in range(self.head, self.tail):
            yield _FinRec(*(a[i] for a in self.cols))


@dataclasses.dataclass(frozen=True)
class TelemetrySample:
    """One rolling-window measurement at simulated time ``time``."""

    time: float
    window: float
    finished_in_window: int
    throughput_jph: float        # finished jobs per hour of simulated time
    jct_p50: float
    jct_p95: float
    jct_p99: float
    wait_p50: float
    wait_p95: float
    wait_p99: float
    utilization: float           # time-weighted busy-GPU fraction in window
    queue_len: int
    running: int
    requeues: int                # fault-driven restarts in window
    vc_fairness: float           # Jain's index over per-VC GPU-seconds
    preemptions: int = 0         # lifecycle preempt/resize evictions in window
    # chaos / degradation mirrors of the engine counters (cumulative; the
    # deltas between consecutive samples localize a burst in time)
    nodes_down: int = 0          # failed (non-retired) nodes at sample time
    reclaimed: int = 0           # jobs spot-reclaimed so far
    milp_fallbacks: int = 0      # solver-eligible allocs degraded to greedy
    degraded_windows: int = 0    # rescan windows forced to FCFS so far
    # prediction mirrors (repro_torch.predict): cumulative reservation/overrun
    # counters off the engine plus the predictor's rolling error metrics
    bf_reservations: int = 0     # predictor-gated backfill commits so far
    bf_overruns: int = 0         # reservations blown (job preempted) so far
    prediction_mape: float = 0.0       # rolling MAPE, MLP p50 head
    baseline_mape: float = 0.0         # rolling MAPE, running-mean baseline

    @property
    def bf_overrun_ratio(self) -> float:
        """Blown reservations per predictor-gated backfill, clamped [0, 1];
        0.0 when no reservation has been made (zero-division safe)."""
        return min(self.bf_overruns / max(self.bf_reservations, 1), 1.0)


def jain_index(shares: list[float]) -> float:
    """Jain's fairness index: 1.0 = perfectly even, 1/n = one VC hogs all."""
    xs = [s for s in shares if s > 0]
    if not xs:
        return 1.0
    s1 = sum(xs)
    s2 = sum(x * x for x in xs)
    return float(s1 * s1 / (len(xs) * s2))


class RollingTelemetry:
    """EngineHooks observer computing rolling-window service metrics."""

    def __init__(self, window: float = 6 * 3600.0,
                 sample_interval: float = 600.0):
        self.window = window
        self.sample_interval = sample_interval
        self.samples: list[TelemetrySample] = []
        self._fin = _FinRing()
        self._requeues = _Ring(1)
        # exact utilization integral: busy fraction is piecewise constant
        # between event batches; (t_start, t_end, busy_frac) segments
        self._segments = _Ring(3)
        self._last_t: float | None = None
        self._first_t: float | None = None
        self._last_busy: float = 0.0
        self._next_sample: float | None = None
        self.total_finished = 0
        # provisioning cost (autoscaling): exact full-run integrals of
        # provisioned (non-retired) and busy GPUs over simulated time, plus
        # the scale events the controller reported via note_scale_events
        self.provisioned_gpu_s = 0.0
        self.used_gpu_s = 0.0
        self.scale_events: list = []
        self._last_prov = 0.0        # provisioned GPUs at the last tick
        self._last_busy_gpus = 0.0   # busy GPUs at the last tick
        # lifecycle accounting (repro_torch.lifecycle): preempt/resume hook
        # counters, resume-penalty GPU-time, controller events, and
        # cross-cluster migration counts reported by the federation
        self.preempt_count = 0
        self.resume_count = 0
        self.resume_penalty_gpu_s = 0.0
        self.preemption_events: list = []
        self.migrations_in = 0
        self.migrations_out = 0
        self._preempts = _Ring(1)
        # chaos accounting (repro_torch.chaos): injector actions plus the engine's
        # degradation counters mirrored at the last tick (getattr-guarded —
        # pre-chaos engines simply read as zero)
        self.chaos_events: list = []
        self.reclaimed_jobs = 0
        self.milp_calls = 0
        self.milp_fallbacks = 0
        self.degraded_windows = 0
        self.degraded_s = 0.0
        self._last_nodes_down = 0
        # prediction accounting (repro_torch.predict): engine counters mirrored at
        # the last tick plus rolling MAPEs read off the attached predictor
        # (getattr-guarded — predictor-less engines simply read as zero)
        self.bf_reservations = 0
        self.bf_overruns = 0
        self.prediction_mape = 0.0
        self.baseline_mape = 0.0
        # per-tick cluster sums memo keyed on (id, version, topo_version):
        # every ClusterState mutation bumps a version, so unchanged-version
        # ticks (arrival batches on a saturated cluster) reuse the sums
        # instead of re-reducing O(n_nodes) arrays; duck-typed clusters
        # without version counters recompute every tick
        self._sums_key = None
        self._sums = (0, 0, 0)

    # ------------------------------------------------------------ hook API ----
    def on_submit(self, job: Job, now: float) -> None: ...

    def on_start(self, job: Job, now: float) -> None: ...

    def on_finish(self, job: Job, now: float) -> None:
        self._fin.append(now, job.jct, job.wait_time, job.vc,
                         job.num_gpus * (now - job.start_time))
        self.total_finished += 1

    def on_requeue(self, job: Job, now: float) -> None:
        self._requeues.append(now)

    def on_preempt(self, job: Job, now: float, penalty_s: float) -> None:
        self.preempt_count += 1
        self.resume_penalty_gpu_s += penalty_s * job.num_gpus
        self._preempts.append(now)

    def on_resume(self, job: Job, now: float) -> None:
        self.resume_count += 1

    def on_tick(self, now: float, engine) -> None:
        if self._last_t is None:
            self._last_t = now
            self._first_t = now
            self._next_sample = now + self.sample_interval
        if now > self._last_t:
            dt = now - self._last_t
            self._segments.append(self._last_t, now, self._last_busy)
            self.provisioned_gpu_s += dt * self._last_prov
            self.used_gpu_s += dt * self._last_busy_gpus
        self._last_t = now
        cluster = engine.cluster
        ver = getattr(cluster, "version", None)
        key = (None if ver is None
               else (id(cluster), ver, getattr(cluster, "topo_version", 0)))
        if key is None or key != self._sums_key:
            mask = ~cluster.retired
            prov = int(cluster.total_gpus[mask].sum())
            busy = int((cluster.total_gpus[mask]
                        - cluster.free_gpus[mask]).sum())
            down = getattr(cluster, "node_down", None)
            ndown = 0 if down is None else int((down & mask).sum())
            self._sums_key = key
            self._sums = (prov, busy, ndown)
        prov, busy, ndown = self._sums
        self._last_prov = float(prov)
        self._last_busy_gpus = float(busy)
        self._last_busy = busy / max(prov, 1)
        self._last_nodes_down = ndown
        self.reclaimed_jobs = getattr(engine, "reclaimed_jobs", 0)
        self.milp_calls = getattr(engine, "milp_calls", 0)
        self.milp_fallbacks = getattr(engine, "milp_fallbacks", 0)
        self.degraded_windows = getattr(engine, "degraded_windows", 0)
        self.degraded_s = getattr(engine, "degraded_s", 0.0)
        self.bf_reservations = getattr(engine, "bf_reservations", 0)
        self.bf_overruns = getattr(engine, "bf_overruns", 0)
        pred = getattr(engine, "predictor", None)
        if pred is not None:
            self.prediction_mape = pred.rolling_mape()
            self.baseline_mape = pred.baseline_rolling_mape()
        self._evict(now)
        if now >= self._next_sample:
            self.samples.append(self._sample(now, engine))
            self._next_sample = now + self.sample_interval

    # ------------------------------------------------------------ internals ----
    def _evict(self, now: float) -> None:
        lo = now - self.window
        self._fin.evict_lt(0, lo)
        self._requeues.evict_lt(0, lo)
        self._preempts.evict_lt(0, lo)
        self._segments.evict_le(1, lo)

    def _windowed_util(self, now: float) -> float:
        lo = now - self.window
        a = self._segments.view(0)
        if a.size:
            # clip to the window and integrate; cumsum accumulates strictly
            # left-to-right, matching the scalar `num += (b-a)*busy` loop
            # term for term in float64
            a2 = np.maximum(a, lo)
            d = self._segments.view(1) - a2
            keep = d > 0
            if keep.any():
                dk = d[keep]
                num = float(np.cumsum(dk * self._segments.view(2)[keep])[-1])
                span = float(np.cumsum(dk)[-1])
                return num / span if span > 0 else self._last_busy
        return self._last_busy

    def _sample(self, now: float, engine) -> TelemetrySample:
        n_fin = len(self._fin)
        if n_fin:
            # one multi-q percentile call per metric: sorts the window once
            # and interpolates each q off the same sorted data — the same
            # values three per-q calls produced, one sort instead of three
            jp50, jp95, jp99 = np.percentile(self._fin.view(1), (50, 95, 99))
            wp50, wp95, wp99 = np.percentile(self._fin.view(2), (50, 95, 99))
            # per-VC GPU-second shares: bincount accumulates weights
            # sequentially in record order (same float adds as the dict
            # loop), reported in first-occurrence order like dict insertion
            vcs = self._fin.view(3)
            uniq, first, inv = np.unique(vcs, return_index=True,
                                         return_inverse=True)
            sums = np.bincount(inv, weights=self._fin.view(4))
            shares = sums[np.argsort(first, kind="stable")].tolist()
        else:
            jp50 = jp95 = jp99 = wp50 = wp95 = wp99 = 0.0
            shares = []
        seg_a = self._segments.view(0)
        span = min(self.window, max(now - (seg_a[0] if seg_a.size else now),
                                    1e-9))
        return TelemetrySample(
            time=now, window=self.window, finished_in_window=n_fin,
            throughput_jph=n_fin * 3600.0 / span,
            jct_p50=float(jp50), jct_p95=float(jp95), jct_p99=float(jp99),
            wait_p50=float(wp50), wait_p95=float(wp95), wait_p99=float(wp99),
            utilization=self._windowed_util(now),
            queue_len=len(engine.pending), running=len(engine.running),
            requeues=len(self._requeues),
            vc_fairness=jain_index(shares),
            preemptions=len(self._preempts),
            nodes_down=self._last_nodes_down,
            reclaimed=self.reclaimed_jobs,
            milp_fallbacks=self.milp_fallbacks,
            degraded_windows=self.degraded_windows,
            bf_reservations=self.bf_reservations,
            bf_overruns=self.bf_overruns,
            prediction_mape=self.prediction_mape,
            baseline_mape=self.baseline_mape,
        )

    # ------------------------------------------------------------ summaries ----
    def probe(self, now: float, engine) -> TelemetrySample:
        """Compute a rolling-window sample at ``now`` without appending it
        to ``samples`` — the streaming-RL reward shaper polls this at every
        rescan-window boundary."""
        return self._sample(now, engine)

    def final(self, engine) -> TelemetrySample:
        """Force one sample at the current clock (end-of-run summary)."""
        now = self._last_t if self._last_t is not None else 0.0
        s = self._sample(now, engine)
        self.samples.append(s)
        return s

    def note_scale_events(self, events) -> None:
        """Record autoscaler actions (provisioning-cost accounting); the
        driver forwards each control tick's emitted ``ScaleEvent``s."""
        self.scale_events.extend(events)

    def note_preemption_events(self, events) -> None:
        """Record lifecycle-controller actions (``PreemptionEvent``s) the
        preemption controller emitted this tick."""
        self.preemption_events.extend(events)

    def note_chaos_events(self, events) -> None:
        """Record chaos-injector actions (``ChaosAction``s) applied this
        control tick."""
        self.chaos_events.extend(events)

    def note_migration(self, kind: str) -> None:
        """Record one cross-cluster migration touching this cluster
        (``kind`` is ``"in"`` or ``"out"``; reported by the federation)."""
        if kind == "in":
            self.migrations_in += 1
        else:
            self.migrations_out += 1

    @property
    def resume_penalty_gpu_hours(self) -> float:
        """GPU-time charged as checkpoint-restore resume penalties — the
        overhead budget preemption spends to win deadline hits."""
        return self.resume_penalty_gpu_s / 3600.0

    @property
    def provisioned_gpu_hours(self) -> float:
        """Integral of provisioned (non-retired) GPUs over simulated time —
        what an elastic deployment pays for."""
        return self.provisioned_gpu_s / 3600.0

    @property
    def used_gpu_hours(self) -> float:
        """Integral of busy GPUs over simulated time."""
        return self.used_gpu_s / 3600.0

    @property
    def degraded_hours(self) -> float:
        """Simulated time the control plane spent FCFS-degraded."""
        return self.degraded_s / 3600.0

    def degraded_fraction(self) -> float:
        """Fraction of the observed span spent FCFS-degraded, clamped to
        [0.0, 1.0].  Both boundaries are exact: an undegraded run reports
        0.0, and a run degraded wall-to-wall reports 1.0 — including the
        zero-length-span corner (a single observed tick inside a degraded
        window), which used to under-report as 0.0."""
        if self._first_t is None or self._last_t is None:
            return 0.0
        span = self._last_t - self._first_t
        if span <= 0:
            return 1.0 if self.degraded_s > 0 else 0.0
        return min(max(self.degraded_s / span, 0.0), 1.0)

    # keep the engine-snapshot spelling available on telemetry too
    @property
    def degraded_ratio(self) -> float:
        """Alias for :meth:`degraded_fraction` matching the snapshot /
        metrics naming (``repro_degraded_*``)."""
        return self.degraded_fraction()

    def milp_fallback_rate(self) -> float:
        """Fraction of solver-eligible allocations that degraded to the
        greedy path, in [0.0, 1.0] at both boundaries: 0.0 when the solver
        was never eligible (no calls, no fallbacks) and exactly 1.0 when
        every eligible allocation fell back."""
        attempts = self.milp_calls + self.milp_fallbacks
        if attempts <= 0:
            return 0.0
        return min(max(self.milp_fallbacks / attempts, 0.0), 1.0)

    def peak_nodes_down(self) -> int:
        return max((s.nodes_down for s in self.samples), default=0)

    def peak_queue_len(self) -> int:
        return max((s.queue_len for s in self.samples), default=0)

    def worst_wait_p99(self) -> float:
        return max((s.wait_p99 for s in self.samples), default=0.0)

    def utilization_timeline(self) -> list[tuple[float, float]]:
        return [(s.time, s.utilization) for s in self.samples]

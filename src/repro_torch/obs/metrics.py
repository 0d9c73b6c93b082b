"""Metrics registry: counters / gauges / histograms + Prometheus text.

A deliberately small, dependency-free subset of the Prometheus client
model, sized for the scheduler control plane:

- ``Counter`` — monotone accumulator (``inc``).
- ``Gauge``   — last-write value (``set`` / ``inc`` / ``dec``).
- ``Histogram`` — cumulative-bucket distribution (``observe``) with
  ``_sum`` / ``_count``, rendered in the standard ``le``-labelled form.

``MetricsRegistry`` owns named metric families; series within a family are
keyed by their label set, so ``reg.counter("repro_fed_routed_total",
cluster="west")`` and ``cluster="east"`` are two series of one family.
``MetricsRegistry.merge`` folds registries together (counters and histogram
buckets sum; gauges sum too — fleet gauges like queue length are additive
across members) — the federation layer uses it to roll per-member
registries into one fleet-level exposition.

``EngineMetricsHook`` is the ``EngineHooks`` observer wiring a registry to
a ``SchedulerEngine``: hook-driven event counters and wait/JCT/alloc-wall
histograms, plus per-tick gauge samples and delta-mirrors of the engine's
cumulative decision/degradation counters.  It never reads ``snapshot()``
on the hot path.
"""
from __future__ import annotations

import math

from repro_torch.sched.engine import EngineHooks

#: Default histogram buckets for control-plane wall-clock latencies (s).
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

#: Default histogram buckets for simulated-time job durations (s):
#: 1 min .. 4 days, roughly geometric.
SIM_DURATION_BUCKETS = (60.0, 300.0, 900.0, 1800.0, 3600.0, 2 * 3600.0,
                        4 * 3600.0, 8 * 3600.0, 16 * 3600.0, 86400.0,
                        2 * 86400.0, 4 * 86400.0)


def _fmt(v: float) -> str:
    """Prometheus sample-value formatting: integral floats render bare."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class Counter:
    """Monotone counter; ``inc`` with a negative amount raises."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        self.value += amount

    def _merge(self, other: "Counter") -> None:
        self.value += other.value


class Gauge:
    """Last-write value."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount

    def _merge(self, other: "Gauge") -> None:
        self.value += other.value


class Histogram:
    """Cumulative-bucket histogram (Prometheus ``le`` semantics)."""

    __slots__ = ("buckets", "counts", "sum", "count")
    kind = "histogram"

    def __init__(self, buckets=LATENCY_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("histogram buckets must be sorted ascending")
        self.counts = [0] * len(self.buckets)   # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
                break

    def cumulative(self) -> list[int]:
        """Cumulative counts per bucket bound (excluding +Inf)."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper bound of the bucket
        holding the q-th observation); 0.0 when empty."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        acc = 0
        for c, b in zip(self.counts, self.buckets):
            acc += c
            if acc >= target:
                return b
        return math.inf

    def _merge(self, other: "Histogram") -> None:
        if other.buckets != self.buckets:
            raise ValueError("cannot merge histograms with different buckets")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Named metric families; get-or-create accessors per (name, labels)."""

    def __init__(self):
        # name -> {"kind": str, "help": str, "series": {labelkey: instrument}}
        self._families: dict[str, dict] = {}

    # ------------------------------------------------------------- create ----
    def _get(self, name: str, kind: str, help_: str, labels: dict, make):
        fam = self._families.get(name)
        if fam is None:
            fam = {"kind": kind, "help": help_, "series": {}}
            self._families[name] = fam
        elif fam["kind"] != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{fam['kind']}, not {kind}")
        key = _label_key(labels)
        inst = fam["series"].get(key)
        if inst is None:
            inst = fam["series"][key] = make()
        return inst

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(name, "gauge", help, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets=LATENCY_BUCKETS, **labels) -> Histogram:
        return self._get(name, "histogram", help, labels,
                         lambda: Histogram(buckets))

    # ------------------------------------------------------------ queries ----
    def value(self, name: str, **labels) -> float:
        """Scalar value of a counter/gauge series (0.0 when absent)."""
        fam = self._families.get(name)
        if fam is None:
            return 0.0
        inst = fam["series"].get(_label_key(labels))
        return 0.0 if inst is None else inst.value

    def families(self) -> dict[str, dict]:
        return self._families

    def as_dict(self) -> dict:
        """JSON-friendly dump (bench artifacts embed this)."""
        out: dict = {}
        for name, fam in sorted(self._families.items()):
            series = {}
            for key, inst in sorted(fam["series"].items()):
                label = ",".join(f"{k}={v}" for k, v in key) or "_"
                if fam["kind"] == "histogram":
                    series[label] = {"sum": inst.sum, "count": inst.count}
                else:
                    series[label] = inst.value
            out[name] = {"kind": fam["kind"], "series": series}
        return out

    # -------------------------------------------------------------- merge ----
    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold ``other`` into this registry in place (fleet roll-up);
        returns self.  Counters/gauges/histogram buckets are summed."""
        for name, fam in other._families.items():
            mine = self._families.get(name)
            if mine is None:
                mine = {"kind": fam["kind"], "help": fam["help"],
                        "series": {}}
                self._families[name] = mine
            elif mine["kind"] != fam["kind"]:
                raise ValueError(f"metric {name!r} kind mismatch on merge")
            for key, inst in fam["series"].items():
                have = mine["series"].get(key)
                if have is None:
                    if fam["kind"] == "histogram":
                        have = Histogram(inst.buckets)
                    else:
                        have = type(inst)()
                    mine["series"][key] = have
                have._merge(inst)
        return self

    @classmethod
    def merged(cls, registries) -> "MetricsRegistry":
        out = cls()
        for reg in registries:
            if reg is not None:
                out.merge(reg)
        return out

    # ------------------------------------------------------------- render ----
    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        lines: list[str] = []
        for name, fam in sorted(self._families.items()):
            if fam["help"]:
                lines.append(f"# HELP {name} {_escape(fam['help'])}")
            lines.append(f"# TYPE {name} {fam['kind']}")
            for key, inst in sorted(fam["series"].items()):
                base = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
                if fam["kind"] != "histogram":
                    suffix = "{" + base + "}" if base else ""
                    lines.append(f"{name}{suffix} {_fmt(inst.value)}")
                    continue
                cum = inst.cumulative()
                for bound, c in zip(inst.buckets, cum):
                    lbl = (base + "," if base else "") + f'le="{_fmt(bound)}"'
                    lines.append(f"{name}_bucket{{{lbl}}} {c}")
                lbl = (base + "," if base else "") + 'le="+Inf"'
                lines.append(f"{name}_bucket{{{lbl}}} {inst.count}")
                suffix = "{" + base + "}" if base else ""
                lines.append(f"{name}_sum{suffix} {_fmt(inst.sum)}")
                lines.append(f"{name}_count{suffix} {inst.count}")
        return "\n".join(lines) + "\n"


#: (metric name, engine attribute) pairs mirrored as delta counters per tick.
_ENGINE_COUNTER_MIRRORS = (
    ("repro_decisions_total", "decisions"),
    ("repro_backfills_total", "backfills"),
    ("repro_restarts_total", "restarts"),
    ("repro_milp_calls_total", "milp_calls"),
    ("repro_milp_fallbacks_total", "milp_fallbacks"),
    ("repro_degraded_windows_total", "degraded_windows"),
    ("repro_reclaimed_jobs_total", "reclaimed_jobs"),
    ("repro_predicted_backfills_total", "bf_reservations"),
    ("repro_backfill_overruns_total", "bf_overruns"),
)


class EngineMetricsHook(EngineHooks):
    """EngineHooks observer feeding a ``MetricsRegistry``.

    All instruments are resolved once at construction (label churn off the
    hot path); ``on_tick`` does a handful of attribute reads and gauge
    sets.  Engine-side cumulative counters (decisions, MILP calls/
    fallbacks, degraded windows, ...) are mirrored as Prometheus counters
    by per-tick deltas so a crashed-and-restored engine never makes a
    counter run backwards."""

    def __init__(self, registry: MetricsRegistry, **labels):
        self.registry = registry
        self.labels = labels
        c, g, h = registry.counter, registry.gauge, registry.histogram
        self._submitted = c("repro_jobs_submitted_total",
                            "jobs accepted into the engine", **labels)
        self._started = c("repro_job_starts_total",
                          "job (re)starts, checkpoint resumes included",
                          **labels)
        self._finished = c("repro_jobs_finished_total",
                           "jobs run to completion", **labels)
        self._requeued = c("repro_jobs_requeued_total",
                           "fault / eviction requeues", **labels)
        self._preempted = c("repro_preemptions_total",
                            "lifecycle checkpoint evictions", **labels)
        self._resumed = c("repro_resumes_total",
                          "checkpoint resumes", **labels)
        self._penalty = c("repro_resume_penalty_seconds_total",
                          "resume-penalty work-seconds charged", **labels)
        self._queue = g("repro_queue_len", "pending jobs", **labels)
        self._running = g("repro_running_jobs", "running jobs", **labels)
        self._free = g("repro_free_gpus", "free GPUs on up nodes", **labels)
        self._util = g("repro_utilization",
                       "busy-GPU fraction, up nodes only", **labels)
        self._down = g("repro_nodes_down",
                       "failed (non-retired) nodes", **labels)
        self._wait = h("repro_job_wait_seconds",
                       "queue wait at first start (simulated)",
                       buckets=SIM_DURATION_BUCKETS, **labels)
        self._jct = h("repro_job_jct_seconds",
                      "job completion time (simulated)",
                      buckets=SIM_DURATION_BUCKETS, **labels)
        self._alloc = h("repro_alloc_wall_seconds",
                        "placement wall-clock per allocation attempt",
                        **labels)
        self._alloc_path = {
            path: c("repro_allocs_total", "successful placements by path",
                    path=path, **labels)
            for path in ("milp", "greedy-fallback", "heuristic")
        }
        self._mirror = [(c(name, f"engine cumulative {attr}", **labels),
                         attr, 0.0)
                        for name, attr in _ENGINE_COUNTER_MIRRORS]
        # prediction instruments (repro_torch.predict): rolling MAPE per model and
        # the reservation-slack distribution (p90 headroom at backfill
        # commit), drained incrementally via the predictor's slack cursor
        self._mape_mlp = g("repro_prediction_mape",
                           "rolling MAPE of predicted runtimes",
                           model="mlp", **labels)
        self._mape_base = g("repro_prediction_mape",
                            "rolling MAPE of predicted runtimes",
                            model="baseline", **labels)
        self._overrun_ratio = g("repro_backfill_overrun_ratio",
                                "blown reservations per predictor-gated "
                                "backfill (clamped [0, 1])", **labels)
        self._slack = h("repro_reservation_slack_seconds",
                        "p90 headroom against the head-job reservation at "
                        "backfill commit (simulated)",
                        buckets=SIM_DURATION_BUCKETS, **labels)
        self._slack_cursor = 0

    # ----------------------------------------------------------- hook API ----
    def on_submit(self, job, now):
        self._submitted.inc()

    def on_start(self, job, now):
        self._started.inc()
        if job.first_start_time == now and job.restarts == 0:
            self._wait.observe(max(now - job.submit_time, 0.0))

    def on_finish(self, job, now):
        self._finished.inc()
        self._jct.observe(max(now - job.submit_time, 0.0))

    def on_requeue(self, job, now):
        self._requeued.inc()

    def on_preempt(self, job, now, penalty_s):
        self._preempted.inc()
        self._penalty.inc(max(penalty_s, 0.0))

    def on_resume(self, job, now):
        self._resumed.inc()

    def on_alloc(self, job, placement, now, wall_s, path):
        self._alloc.observe(wall_s)
        if placement is not None:
            self._alloc_path[path].inc()

    def on_tick(self, now, engine):
        self._queue.set(len(engine.pending))
        self._running.set(len(engine.running))
        cluster = engine.cluster
        free, _ = cluster.free_gpu_tallies()
        self._free.set(free)
        self._util.set(cluster.utilization(up_only=True))
        self._down.set(int((cluster.node_down & ~cluster.retired).sum()))
        mirror = self._mirror
        for i, (counter, attr, last) in enumerate(mirror):
            val = float(getattr(engine, attr, 0.0))
            if val > last:
                counter.inc(val - last)
                mirror[i] = (counter, attr, val)
        pred = getattr(engine, "predictor", None)
        if pred is not None:
            self._mape_mlp.set(pred.rolling_mape())
            self._mape_base.set(pred.baseline_rolling_mape())
            res = getattr(engine, "bf_reservations", 0)
            self._overrun_ratio.set(
                min(getattr(engine, "bf_overruns", 0) / max(res, 1), 1.0))
            slacks, self._slack_cursor = \
                pred.recent_slacks(self._slack_cursor)
            for s in slacks:
                self._slack.observe(s)

    # ------------------------------------------------- controller counters ----
    def note_controller(self, kind: str, n_events: int) -> None:
        """Count controller-tick actions (autoscaler / preemption / chaos);
        the service loop forwards each tick's emitted event count."""
        self.registry.counter("repro_controller_ticks_total",
                              "controller control ticks",
                              controller=kind, **self.labels).inc()
        if n_events:
            self.registry.counter("repro_controller_events_total",
                                  "controller actions emitted",
                                  controller=kind, **self.labels).inc(n_events)

"""repro_torch.obs — end-to-end observability for the scheduling control plane.

One ``Observability`` bundle owns the three sinks and is what drivers
pass around (``run_stream(..., obs=obs)`` / ``run_fleet(..., obs=obs)``):

- :class:`~repro_torch.obs.tracer.SpanTracer` — job-lifecycle + control-plane
  spans, exported as Chrome trace-event JSON (Perfetto-loadable).
- :class:`~repro_torch.obs.metrics.MetricsRegistry` (fed by
  :class:`~repro_torch.obs.metrics.EngineMetricsHook`) — counters / gauges /
  histograms with a Prometheus text exporter and fleet-level merge.
- :class:`~repro_torch.obs.audit.DecisionAuditLog` — per-decision rank-path /
  allocator / skip-reason accounting.
- the span recorder :mod:`repro_torch.core.spans` (also
  ``from repro_torch.obs import spans``), off by default and switched on
  with ``spans.enable()``: nested spans and counters inside the
  scheduling pass — ``rltune.step`` and its ``rltune.events`` /
  ``rltune.schedule`` / ``rltune.hooks`` parts, the ranking
  (``rltune.rank`` with ``.features`` / ``.actor`` / ``.tail``), head
  placements (``rltune.place.head`` / ``.head_failed``), HiGHS solves
  (``rltune.milp.solve``), the EASY scan (``rltune.backfill`` /
  ``.reserve``) and the predictor (``rltune.predict.rows`` / ``.forward``
  / ``.sgd`` / ``.submit``); counters for decisions and futile decisions
  (``rank.*``), the MILP solution cache (``milp.hits`` / ``.solves`` /
  ``.greedy``), the backfill scan's placement attempts
  (``backfill.tried`` / ``.failed``), the predictor's weight uploads
  (``predict.param_uploads``) and copies to and from the card
  (``device.*``).  While the recorder is on, the bundle's views carry
  it: its spans join the trace document as complete events on the
  control-plane track (``tid`` ``"spans"``, the tracer's wall origin),
  its totals and counters the Prometheus text as
  ``repro_span_seconds_total{span=...}`` (wall),
  ``repro_span_calls_total{span=...}`` and ``repro_<counter>_total``
  (dots as underscores).  An engine built or restored under
  ``torch.profiler`` also switches it on, until its first step after the
  profiler stopped; its clock maps onto the profiler's trace.

``obs.hooks()`` yields the hook objects to attach to an engine (the
service loop composes them with telemetry and RL recorders through
``MultiHooks``); ``obs.member(i, name)`` derives a per-federation-member
child whose trace events and metrics roll up into the fleet-level
``export_trace`` / ``prometheus`` views.

Everything here is observational: with ``obs=None`` the engine and
drivers take bit-identical code paths (pinned by ``tests/test_obs.py``).
"""
from __future__ import annotations

import time

from repro_torch.core import spans
from repro_torch.obs.audit import DecisionAuditLog
from repro_torch.obs.metrics import (Counter, EngineMetricsHook, Gauge,
                                     Histogram, MetricsRegistry)
from repro_torch.obs.tracer import SpanTracer, merge_documents, validate_trace

__all__ = [
    "Observability", "SpanTracer", "MetricsRegistry", "EngineMetricsHook",
    "DecisionAuditLog", "Counter", "Gauge", "Histogram",
    "merge_documents", "validate_trace",
]


class Observability:
    """Bundle of tracer + metrics + audit log for one engine (or, via
    :meth:`member`, one federation).  Any sink can be switched off at
    construction; ``hooks()`` only returns the live ones.  The views
    carry the process-wide span recorder while it is on (see the module
    docstring); the fleet-merged views carry it once, with the root."""

    def __init__(self, *, name: str = "cluster", member: int = 0,
                 trace: bool = True, metrics: bool = True,
                 audit: bool = True, max_trace_events: int = 2_000_000,
                 keep_audit_records: int = 10_000):
        self.name = name
        self.tracer = SpanTracer(name=name, member=member,
                                 max_events=max_trace_events) \
            if trace else None
        self.registry = MetricsRegistry() if metrics else None
        self.metrics_hook = EngineMetricsHook(self.registry, cluster=name) \
            if metrics else None
        self.audit = DecisionAuditLog(keep=keep_audit_records) \
            if audit else None
        self._members: dict[int, "Observability"] = {}
        self._finalized = False
        self._wall_start = time.perf_counter()
        self.wall_elapsed_s = 0.0

    # -------------------------------------------------------------- hooks ----
    def hooks(self) -> tuple:
        """Hook objects to attach to one engine, in dispatch order."""
        return tuple(h for h in (self.tracer, self.metrics_hook, self.audit)
                     if h is not None)

    # ---------------------------------------------------------- federation ----
    def member(self, i: int, name: str | None = None) -> "Observability":
        """Per-federation-member child bundle (memoized).  Members get
        disjoint trace pids and a ``cluster`` metric label of their own;
        fleet-level views merge them."""
        child = self._members.get(i)
        if child is None:
            child = Observability(
                name=name or f"{self.name}/{i}", member=i + 1,
                trace=self.tracer is not None,
                metrics=self.registry is not None,
                audit=self.audit is not None,
                max_trace_events=(self.tracer.max_events
                                  if self.tracer is not None else 0),
                keep_audit_records=(self.audit.keep
                                    if self.audit is not None else 0))
            self._members[i] = child
        return child

    def members(self) -> list["Observability"]:
        return [self._members[i] for i in sorted(self._members)]

    # --------------------------------------------------- control-plane API ----
    def note_controller(self, kind: str, n_events: int, wall_s: float,
                        now: float) -> None:
        """Record one controller tick (autoscaler / preemption / chaos /
        fleet-chaos): a wall-clock control-plane span plus tick/action
        counters.  The service loop calls this at every window edge."""
        if self.tracer is not None:
            self.tracer.control_span(kind, kind, wall_s, sim_t=now,
                                     events=n_events)
        if self.metrics_hook is not None:
            self.metrics_hook.note_controller(kind, n_events)

    def note_window(self, now: float, wall_s: float, processed: int) -> None:
        """Record one processed rescan window (engine.step to the edge)."""
        if self.tracer is not None:
            self.tracer.control_span("window-step", "window", wall_s,
                                     sim_t=now, events=processed)
        if self.registry is not None:
            self.registry.counter("repro_rescan_windows_total",
                                  "processed rescan windows",
                                  cluster=self.name).inc()

    def count(self, name: str, help: str = "", n: float = 1.0,
              **labels) -> None:
        """Bump a fleet-level counter (routing / deferral / migration);
        no-op with metrics off."""
        if self.registry is not None:
            self.registry.counter(name, help, **labels).inc(n)

    # ----------------------------------------------------------- finalize ----
    def finalize(self, engine=None) -> None:
        """Close open spans and take a final metrics sample.  Idempotent;
        drivers call it once at end-of-stream."""
        if self._finalized:
            return
        self._finalized = True
        self.wall_elapsed_s = time.perf_counter() - self._wall_start
        if self.tracer is not None:
            now = engine.now if engine is not None else None
            self.tracer.finalize(now)
        if self.metrics_hook is not None and engine is not None:
            self.metrics_hook.on_tick(engine.now, engine)

    def finalize_fleet(self, fed) -> None:
        """Finalize every member bundle against its engine."""
        for i, child in self._members.items():
            child.finalize(fed.engines[i] if i < len(fed.engines) else None)
        self.finalize()

    # -------------------------------------------------------------- views ----
    def trace_document(self) -> dict:
        """Fleet-merged Chrome trace document (self + members)."""
        docs = []
        if self.tracer is not None:
            docs.append(self.tracer.to_document())
            if spans.ACTIVE is not None:
                docs[0]["traceEvents"].extend(self._span_events(spans.ACTIVE))
        docs.extend(m.tracer.to_document() for m in self.members()
                    if m.tracer is not None)
        if len(docs) == 1:
            return docs[0]
        return merge_documents(docs)

    def export_trace(self, path: str) -> str:
        import json
        with open(path, "w") as fh:
            json.dump(self.trace_document(), fh)
        return path

    def _span_events(self, rec) -> list[dict]:
        """The recorder's timeline as complete events on the control-plane
        track, in µs from the tracer's wall origin."""
        tr = self.tracer
        origin = tr._wall0 * 1e6
        return [{"name": rec.names[nid], "ph": "X", "cat": "span",
                 "ts": max(int(round(s / 1e3 - origin)), 0),
                 "dur": max(int(round((e - s) / 1e3)), 0),
                 "pid": tr.ctrl_pid, "tid": "spans", "args": {"depth": d}}
                for s, e, nid, d in rec.events]

    @staticmethod
    def _span_registry(rec) -> MetricsRegistry:
        reg = MetricsRegistry()
        for name, (n, wall, _) in sorted(rec.totals.items()):
            reg.counter("repro_span_seconds_total",
                        "wall seconds inside each span",
                        span=name).inc(wall / 1e9)
            reg.counter("repro_span_calls_total", "spans closed",
                        span=name).inc(n)
        for name, n in sorted(rec.counters.items()):
            reg.counter(f"repro_{name.replace('.', '_')}_total",
                        f"span recorder counter {name}").inc(n)
        return reg

    def merged_registry(self) -> MetricsRegistry:
        """Fleet-merged metrics registry (self + members), with the span
        span recorder's totals and counters while it is on."""
        regs = [self.registry] + [m.registry for m in self.members()]
        if spans.ACTIVE is not None:
            regs.append(self._span_registry(spans.ACTIVE))
        return MetricsRegistry.merged(r for r in regs if r is not None)

    def prometheus(self) -> str:
        """Fleet-merged Prometheus text exposition."""
        return self.merged_registry().render()

    def write_prometheus(self, path: str) -> str:
        with open(path, "w") as fh:
            fh.write(self.prometheus())
        return path

    def audit_summary(self) -> dict:
        """Audit aggregate; per-member summaries attached under
        ``members`` when federation children exist."""
        out = self.audit.summary() if self.audit is not None else {}
        if self._members:
            out = dict(out)
            out["members"] = {m.name: m.audit.summary()
                              for m in self.members()
                              if m.audit is not None}
        return out

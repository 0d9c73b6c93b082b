"""Span tracer: job lifecycle + control-plane spans as Chrome trace events.

``SpanTracer`` is an ``EngineHooks`` observer that records two timelines
into one Chrome trace-event JSON document (the ``{"traceEvents": [...]}``
format Perfetto and ``chrome://tracing`` load directly):

- **Job lifecycle** (simulated time, one track per job): every job renders
  as alternating ``queued`` / ``running`` complete spans
  (submit -> start -> preempt/evict -> resume -> finish), with instant
  events marking preemptions (resume penalty attached), fault requeues,
  and checkpoint resumes.  ``tid`` is the job id; ``ts`` is microseconds
  of simulated time since the first observed instant.
- **Control plane** (wall-clock time, its own process track): per-decision
  ``rank`` spans (policy vs FCFS-degraded path, from the engine's audit
  stream), per-attempt ``alloc`` spans (MILP / greedy-fallback /
  heuristic), and per-rescan-window autoscaler / preemption / chaos
  controller ticks forwarded by the service loop.

The two timelines use different clocks, so they live in different trace
``pid``s — each is internally consistent, and control-plane events carry
``sim_t`` in ``args`` for cross-referencing.  ``validate_trace`` checks
the exported document against the trace-event schema (CI gates on it).

Jobs paused or migrated away (``pause_job`` / ``withdraw_pending`` fire no
engine hooks by design) keep their last span open until a later hook or
:meth:`finalize` closes it; cross-cluster migrations therefore appear as a
span ending on the source member's track and a fresh ``queued`` span
opening on the destination's.
"""
from __future__ import annotations

import json
import time

from repro_torch.sched.engine import EngineHooks

#: trace pid carrying simulated-time job spans (offset by member index).
JOB_PID_BASE = 1
#: trace pid carrying wall-clock control-plane spans.
CONTROL_PID_BASE = 1001

_REQUIRED_KEYS = {"name", "ph", "ts", "pid", "tid"}


class SpanTracer(EngineHooks):
    """EngineHooks observer emitting Chrome trace events.

    ``member`` offsets the job/control pids so per-federation-member
    tracers merge into one fleet trace without track collisions.
    ``max_events`` bounds memory: past it, new events are counted in
    ``dropped`` instead of stored (open-span bookkeeping still runs, so
    spans that close after the cap don't corrupt earlier ones).
    """

    def __init__(self, *, name: str = "cluster", member: int = 0,
                 max_events: int = 2_000_000,
                 counter_interval: float = 600.0):
        self.name = name
        self.member = member
        self.job_pid = JOB_PID_BASE + member
        self.ctrl_pid = CONTROL_PID_BASE + member
        self.max_events = max_events
        self.counter_interval = counter_interval
        self.events: list[dict] = []
        self.dropped = 0
        self._t0: float | None = None          # sim-time origin
        self._wall0 = time.perf_counter()      # wall-time origin
        self._queued_since: dict[int, float] = {}
        self._running_since: dict[int, float] = {}
        self._preempting: set[int] = set()
        self._next_counter: float | None = None
        self._meta()

    # ---------------------------------------------------------- low level ----
    def _meta(self) -> None:
        for pid, label in ((self.job_pid, f"{self.name} jobs (sim time)"),
                           (self.ctrl_pid,
                            f"{self.name} control plane (wall clock)")):
            self.events.append({"name": "process_name", "ph": "M",
                                "pid": pid, "tid": 0, "ts": 0,
                                "args": {"name": label}})

    def _emit(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def _sim_us(self, t: float) -> int:
        if self._t0 is None:
            self._t0 = t
        return int(round((t - self._t0) * 1e6))

    def _wall_us(self) -> int:
        return int(round((time.perf_counter() - self._wall0) * 1e6))

    def _job_span(self, name: str, jid: int, t_start: float, t_end: float,
                  **args) -> None:
        ts = self._sim_us(t_start)
        self._emit({"name": name, "ph": "X", "cat": "job", "ts": ts,
                    "dur": max(self._sim_us(t_end) - ts, 0),
                    "pid": self.job_pid, "tid": jid, "args": args})

    def _job_instant(self, name: str, jid: int, t: float, **args) -> None:
        self._emit({"name": name, "ph": "i", "cat": "job", "s": "t",
                    "ts": self._sim_us(t), "pid": self.job_pid, "tid": jid,
                    "args": args})

    def control_span(self, name: str, tid: str, wall_s: float,
                     **args) -> None:
        """Record a wall-clock control-plane span ending *now* (the service
        loop and engine call this right after timing the work)."""
        dur = max(int(round(wall_s * 1e6)), 0)
        # clamp: a span timed before this tracer's wall origin (e.g. handed
        # in from an older clock) must not produce a negative timestamp
        ts = max(self._wall_us() - dur, 0)
        self._emit({"name": name, "ph": "X", "cat": "control",
                    "ts": ts, "dur": dur,
                    "pid": self.ctrl_pid, "tid": tid, "args": args})

    # ----------------------------------------------------------- hook API ----
    def on_submit(self, job, now):
        self._queued_since[job.job_id] = now

    def on_start(self, job, now):
        jid = job.job_id
        q = self._queued_since.pop(jid, None)
        if q is not None:
            self._job_span("queued", jid, q, now,
                           gpus=job.num_gpus, restarts=job.restarts)
        self._running_since[jid] = now

    def on_finish(self, job, now):
        jid = job.job_id
        r = self._running_since.pop(jid, None)
        if r is not None:
            self._job_span("running", jid, r, now, gpus=job.num_gpus,
                           restarts=job.restarts)
        self._job_instant("finish", jid, now, jct=job.jct)

    def on_preempt(self, job, now, penalty_s):
        jid = job.job_id
        r = self._running_since.pop(jid, None)
        if r is not None:
            self._job_span("running", jid, r, now, gpus=job.num_gpus,
                           restarts=job.restarts, evicted="preempt")
        self._preempting.add(jid)
        self._job_instant("preempt", jid, now, penalty_s=penalty_s)

    def on_requeue(self, job, now):
        jid = job.job_id
        r = self._running_since.pop(jid, None)
        if r is not None:
            # a requeue with an open running span and no preceding
            # on_preempt is a fault kill (or a resume from pause, whose
            # pause instant was unobservable — the span runs to here)
            self._job_span("running", jid, r, now, gpus=job.num_gpus,
                           restarts=job.restarts, evicted="fault")
        if jid in self._preempting:
            self._preempting.discard(jid)
        else:
            self._job_instant("requeue", jid, now)
        self._queued_since[jid] = now

    def on_resume(self, job, now):
        self._job_instant("resume", job.job_id, now,
                          progress=job.progress_at_ckpt)

    def on_tick(self, now, engine):
        if self._next_counter is None:
            self._next_counter = now
        if now >= self._next_counter:
            self._emit({"name": "load", "ph": "C", "ts": self._sim_us(now),
                        "pid": self.job_pid, "tid": 0,
                        "args": {"pending": len(engine.pending),
                                 "running": len(engine.running)}})
            self._next_counter = now + self.counter_interval

    # -- engine audit stream (gated: only fires when a hook defines these) --
    def on_alloc(self, job, placement, now, wall_s, path):
        self.control_span(f"alloc:{path}", "alloc", wall_s, sim_t=now,
                          job=job.job_id, placed=placement is not None,
                          gpus=job.num_gpus)

    def on_decision_audit(self, rec):
        self.control_span(f"rank:{rec['path']}", "rank",
                          rec.get("rank_wall_s", 0.0), sim_t=rec["now"],
                          window=rec["window"], top_job=rec["top_job"],
                          placed=rec["placed"], skips=rec.get("skips", {}))

    def on_window_blocked(self, now, queued):
        self._emit({"name": "window-blocked", "ph": "i", "cat": "control",
                    "s": "p", "ts": self._wall_us(), "pid": self.ctrl_pid,
                    "tid": "rank", "args": {"sim_t": now, "queued": queued}})

    # ----------------------------------------------------------- finalize ----
    def finalize(self, now: float | None = None) -> None:
        """Close spans still open at end-of-run (jobs queued or running
        when the stream ended, paused/migrated-away jobs).  Safe on a
        tracer that never emitted a span — e.g. a run that ended with
        every job still queued — where the sim origin is seeded from the
        earliest open timestamp instead of being lost."""
        open_ts = list(self._queued_since.values()) \
            + list(self._running_since.values())
        if self._t0 is None:
            if not open_ts:
                return
            self._t0 = min(open_ts)
        if now is None:
            now = max(open_ts, default=self._t0)
        for jid, q in list(self._queued_since.items()):
            self._job_span("queued", jid, q, max(now, q), open_at_end=True)
        self._queued_since.clear()
        for jid, r in list(self._running_since.items()):
            self._job_span("running", jid, r, max(now, r), open_at_end=True)
        self._running_since.clear()

    def to_document(self) -> dict:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"tracer": self.name,
                              "dropped_events": self.dropped,
                              # sim-time origin per job pid: report tooling
                              # maps span ts back to absolute sim seconds
                              "sim_t0": {str(self.job_pid):
                                         self._t0 if self._t0 is not None
                                         else 0.0}}}

    def export(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_document(), fh)
        return path


def merge_documents(docs) -> dict:
    """Merge per-member trace documents into one fleet document (members
    already occupy disjoint pids via the ``member`` offset)."""
    events: list[dict] = []
    dropped = 0
    t0s: dict = {}
    for doc in docs:
        events.extend(doc.get("traceEvents", ()))
        other = doc.get("otherData", {})
        dropped += other.get("dropped_events", 0)
        t0s.update(other.get("sim_t0", {}))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"tracer": "fleet", "dropped_events": dropped,
                          "sim_t0": t0s}}


def validate_trace(doc) -> list[str]:
    """Validate a trace-event document; returns a list of problems (empty
    = valid).  Checks the JSON-object envelope, per-event required keys,
    known phase codes, numeric non-negative ``ts``/``dur``, and that
    complete/instant/counter/metadata events carry the right fields."""
    problems: list[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["document is not an object with a 'traceEvents' key"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' is not a list"]
    if not events:
        problems.append("'traceEvents' is empty")
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        missing = _REQUIRED_KEYS - ev.keys()
        if missing:
            problems.append(f"{where}: missing keys {sorted(missing)}")
            continue
        ph = ev["ph"]
        if ph not in ("X", "B", "E", "i", "I", "C", "M", "b", "e", "n",
                      "s", "t", "f"):
            problems.append(f"{where}: unknown phase {ph!r}")
            continue
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: complete event with bad "
                                f"dur {dur!r}")
        if ph == "C" and not isinstance(ev.get("args"), dict):
            problems.append(f"{where}: counter event without args")
        if ph == "M" and "args" not in ev:
            problems.append(f"{where}: metadata event without args")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"{where}: args is not an object")
    return problems

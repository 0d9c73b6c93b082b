"""Trace-file reporter: ``python -m repro_torch.obs.report TRACE.json``.

Reads a Chrome trace-event document exported by ``repro_torch.obs`` and prints:

- a **critical-path summary**: the top-K jobs by total lifecycle span
  (queued + running, preemption restarts included), with the queue /
  compute breakdown that says where each job's time actually went;
- a **top-queueing-cause summary**: decision-path counts (policy vs
  FCFS-degraded), allocator-path counts (MILP vs greedy fallback vs
  heuristic), capacity-blocked window count, and the top-k skip reasons
  from the engine's audit stream — fleet-wide, plus a per-job attribution
  over each critical-path job's longest wait.

``--validate`` checks the document against the trace-event schema first
and exits non-zero on any violation (the CI smoke job gates on this).
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys

from repro_torch.obs.tracer import validate_trace


def _fmt_h(seconds: float) -> str:
    return f"{seconds / 3600.0:8.2f}h"


class JobTrack:
    """Per-job roll-up of ``cat == "job"`` spans and instants."""

    __slots__ = ("pid", "jid", "queued_s", "running_s", "preempts",
                 "requeues", "finished", "intervals", "gpus", "restarts")

    def __init__(self, pid, jid):
        self.pid = pid
        self.jid = jid
        self.queued_s = 0.0
        self.running_s = 0.0
        self.preempts = 0
        self.requeues = 0
        self.finished = False
        self.intervals = []       # absolute-sim-time (start, end) queued
        self.gpus = 0
        self.restarts = 0

    @property
    def total_s(self) -> float:
        return self.queued_s + self.running_s

    def longest_wait(self):
        return max(self.intervals, key=lambda iv: iv[1] - iv[0],
                   default=None)


def load_trace(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def analyze(doc: dict) -> dict:
    """Fold a trace document into the report's working model."""
    t0s = {int(k): float(v)
           for k, v in doc.get("otherData", {}).get("sim_t0", {}).items()}
    jobs: dict[tuple, JobTrack] = {}
    path_counts: collections.Counter = collections.Counter()
    alloc_counts: collections.Counter = collections.Counter()
    skip_counts: collections.Counter = collections.Counter()
    rank_events: list[tuple[float, dict]] = []   # (sim_t, skips)
    blocked = 0
    rank_wall_s = 0.0

    for ev in doc.get("traceEvents", ()):
        cat = ev.get("cat")
        name = ev.get("name", "")
        if cat == "job":
            key = (ev["pid"], ev["tid"])
            jt = jobs.get(key)
            if jt is None:
                jt = jobs[key] = JobTrack(*key)
            args = ev.get("args", {})
            if ev["ph"] == "X":
                dur_s = ev.get("dur", 0) / 1e6
                if name == "queued":
                    jt.queued_s += dur_s
                    base = t0s.get(ev["pid"], 0.0)
                    start = base + ev["ts"] / 1e6
                    jt.intervals.append((start, start + dur_s))
                elif name == "running":
                    jt.running_s += dur_s
                jt.gpus = max(jt.gpus, args.get("gpus", 0))
                jt.restarts = max(jt.restarts, args.get("restarts", 0))
            elif ev["ph"] == "i":
                if name == "preempt":
                    jt.preempts += 1
                elif name == "requeue":
                    jt.requeues += 1
                elif name == "finish":
                    jt.finished = True
        elif cat == "control" and ev.get("ph") == "X" \
                and name.startswith("rank:"):
            args = ev.get("args", {})
            path_counts[name.split(":", 1)[1]] += 1
            rank_wall_s += ev.get("dur", 0) / 1e6
            skips = args.get("skips") or {}
            for reason, n in skips.items():
                skip_counts[reason] += n
            rank_events.append((args.get("sim_t", 0.0), skips))
        elif cat == "control" and ev.get("ph") == "X" \
                and name.startswith("alloc:"):
            if ev.get("args", {}).get("placed"):
                alloc_counts[name.split(":", 1)[1]] += 1
        elif cat == "control" and name == "window-blocked":
            blocked += 1

    rank_events.sort(key=lambda kv: kv[0])
    return {"jobs": jobs, "path_counts": path_counts,
            "alloc_counts": alloc_counts, "skip_counts": skip_counts,
            "rank_events": rank_events, "blocked_windows": blocked,
            "rank_wall_s": rank_wall_s}


def _attribute_wait(model: dict, jt: JobTrack, k: int = 3):
    """Skip-reason tallies over the decisions made during ``jt``'s longest
    queued interval — 'what was the scheduler doing while this job sat'."""
    iv = jt.longest_wait()
    if iv is None or not model["rank_events"]:
        return []
    times = [t for t, _ in model["rank_events"]]
    lo = bisect.bisect_left(times, iv[0])
    hi = bisect.bisect_right(times, iv[1])
    local: collections.Counter = collections.Counter()
    for _, skips in model["rank_events"][lo:hi]:
        for reason, n in skips.items():
            local[reason] += n
    return local.most_common(k)


def print_report(doc: dict, top: int = 10, out=None) -> None:
    # sys.stdout resolved at call time, not def time — callers (and tests)
    # that swap stdout still capture the report
    out = out if out is not None else sys.stdout
    model = analyze(doc)
    jobs = sorted(model["jobs"].values(), key=lambda j: -j.total_s)
    w = out.write

    w(f"critical path — top {min(top, len(jobs))} of {len(jobs)} traced "
      f"jobs by lifecycle span\n")
    w(f"{'job':>10} {'total':>9} {'queued':>9} {'running':>9} "
      f"{'gpus':>5} {'restarts':>8} {'preempts':>8}  dominant wait cause\n")
    for jt in jobs[:top]:
        causes = _attribute_wait(model, jt, k=1)
        cause = f"{causes[0][0]} x{causes[0][1]}" if causes else "-"
        w(f"{jt.jid!s:>10} {_fmt_h(jt.total_s)} {_fmt_h(jt.queued_s)} "
          f"{_fmt_h(jt.running_s)} {jt.gpus:>5} {jt.restarts:>8} "
          f"{jt.preempts:>8}  {cause}\n")

    w("\ndecision paths (who ranked each window)\n")
    total = sum(model["path_counts"].values()) or 1
    for path, n in model["path_counts"].most_common():
        w(f"  {path:<16} {n:>8}  ({100.0 * n / total:5.1f}%)\n")
    if not model["path_counts"]:
        w("  (no rank spans in trace)\n")

    w("\nallocator paths (who placed each started job)\n")
    for path, n in model["alloc_counts"].most_common():
        w(f"  {path:<16} {n:>8}\n")
    if not model["alloc_counts"]:
        w("  (no alloc spans in trace)\n")

    w("\ntop queueing causes (jobs passed over, fleet-wide)\n")
    for reason, n in model["skip_counts"].most_common(5):
        w(f"  {reason:<24} {n:>8}\n")
    if not model["skip_counts"]:
        w("  (no skips recorded)\n")
    w(f"  capacity-blocked windows {model['blocked_windows']:>8}\n")
    w(f"  ranking wall-clock total {model['rank_wall_s']:>8.3f}s\n")
    dropped = doc.get("otherData", {}).get("dropped_events", 0)
    if dropped:
        w(f"\nWARNING: {dropped} events dropped at the tracer cap — "
          f"summaries undercount\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a repro_torch.obs Chrome trace-event file.")
    ap.add_argument("trace", help="trace JSON exported by repro_torch.obs")
    ap.add_argument("--top", type=int, default=10,
                    help="critical-path rows to print (default 10)")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check the trace; non-zero exit on any "
                         "violation")
    args = ap.parse_args(argv)
    try:
        doc = load_trace(args.trace)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"error: cannot load {args.trace}: {exc}", file=sys.stderr)
        return 2
    if args.validate:
        problems = validate_trace(doc)
        if problems:
            for p in problems:
                print(f"schema violation: {p}", file=sys.stderr)
            return 1
        print(f"trace OK: {len(doc['traceEvents'])} events")
    try:
        print_report(doc, top=args.top)
    except BrokenPipeError:
        # reader (e.g. `| head`) closed the pipe — not an error; point
        # stdout at devnull so the interpreter's exit flush stays quiet
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
    return 0


if __name__ == "__main__":
    sys.exit(main())

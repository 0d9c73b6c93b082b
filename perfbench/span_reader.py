"""The program's own spans and counters, read by the benchmark.

The port records spans and counters inside its scheduling pass
(``repro_torch.core.spans``).  Under ``torch.profiler`` the recorder
switches itself on when an engine is restored, so a ``--trace 1`` run's
window carries it from its first restore; it goes off at the first step
after the profiler stopped, and no step follows the window in a run.
``view`` finds its totals and counters (from ``ctx["spans"]`` and
``ctx["counters"]`` where the run puts them there, else from the
recorder), which the per-layer readers in ``perfbench/metrics/`` turn
into numbers a pass.  A program without the recorder (an older checkout)
gives ``None``, and so does every reader that needs it.

The recorder's clock maps onto the profiler's trace through its
``rltune.anchor`` event, so ``name_gaps`` can put each device-idle gap
down to the program span that was running, and ``count_copies`` counts
the trace's host-device copies outside the benchmark's own ranges.  Run

    python3 -m perfbench.span_reader --workload NAME --seed N --seconds S

from the root of a checkout (on the card) for a traced run of the cell
whose standard error ends with the ten longest idle gaps, each named by
the innermost span that covers most of it, and the closure of the spans
against the benchmark's outside timers.
"""
from __future__ import annotations

import bisect
import json
import sys

#: the benchmark's own host ranges whose copies are not the program's
OUTSIDE = ("perfbench.restore", "perfbench.digest", "perfbench.gc")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def recorder():
    """The program's span recorder (on, or the last one on), or None."""
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    return getattr(spans, "ACTIVE", None) or getattr(spans, "LAST", None)


def view(ctx: dict):
    """(totals, counters) for the window: ``ctx["spans"]`` and
    ``ctx["counters"]`` where the run put them there, else the program's
    recorder; None where there is neither."""
    if "spans" in ctx:
        if ctx["spans"] is None:
            return None
        return ctx["spans"], ctx.get("counters") or {}
    rec = recorder()
    if rec is None:
        return None
    return rec.totals, rec.counters


def self_ms_per_pass(ctx: dict, *names: str, wall: bool = False):
    """Summed self time (or wall) of the spans ``names`` a pass, in ms."""
    v = view(ctx)
    if v is None or not ctx.get("passes"):
        return None
    totals = v[0]
    k = 1 if wall else 2
    ns = sum(totals[n][k] for n in names if n in totals)
    return ns / 1e6 / ctx["passes"]


def counter_per_pass(ctx: dict, *names: str):
    """Summed counters ``names`` a pass."""
    v = view(ctx)
    if v is None or not ctx.get("passes"):
        return None
    return sum(v[1].get(n, 0) for n in names) / ctx["passes"]


def calls_pct(ctx: dict, part: str, *whole: str):
    """100 times the closed spans ``part`` over those of ``whole`` (None
    when there are none)."""
    v = view(ctx)
    if v is None:
        return None
    t = v[0]
    den = sum(t[n][0] for n in whole if n in t)
    if den <= 0:
        return None
    return 100.0 * (t[part][0] if part in t else 0) / den


def counter_pct(ctx: dict, part: str, *whole: str):
    """100 times a counter over the sum of others (None when that is 0)."""
    v = view(ctx)
    if v is None:
        return None
    c = v[1]
    den = sum(c.get(n, 0) for n in whole)
    if den <= 0:
        return None
    return 100.0 * c.get(part, 0) / den


# ---------------------------------------------------------------- the trace --
def _events(doc: dict) -> list:
    return [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]


def span_intervals(doc: dict, rec) -> list[tuple[float, float, str, int]]:
    """The recorder's events on the trace's ``ts`` axis (µs), as
    ``(start, end, name, depth)``, through the last ``rltune.anchor``."""
    anchors = [e for e in _events(doc) if e.get("name") == "rltune.anchor"]
    end_us = None
    if anchors:
        a = max(anchors, key=lambda e: float(e["ts"]))
        end_us = float(a["ts"]) + float(a.get("dur", 0.0))
    base = doc.get("baseTimeNanoseconds")
    out = []
    for s, e, nid, d in rec.events:
        out.append((rec.trace_us(s, end_us, base),
                    rec.trace_us(e, end_us, base), rec.names[nid], d))
    return out


def device_gaps(doc: dict) -> list[tuple[float, float]]:
    """Gaps between the device's busy intervals, longest first."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e in _events(doc) if e.get("cat", "") in DEVICE_CATS)
    gaps, cur = [], None
    for s, t in dev:
        if cur is not None and s > cur:
            gaps.append((cur, s))
        cur = t if cur is None else max(cur, t)
    gaps.sort(key=lambda g: g[0] - g[1])
    return gaps


def name_gap(a: float, b: float, spans: list, ranges: list) -> tuple:
    """Put each instant of [a, b] down to the innermost interval over it
    (a program span before a benchmark range; the deeper span, the shorter
    range) and return (the name with the most time, {name: µs})."""
    over = [(s, t, n, (1, d)) for s, t, n, d in spans if s < b and t > a]
    over += [(s, t, n, (0, -(t - s))) for s, t, n in ranges
             if s < b and t > a]
    cuts = sorted({a, b} | {min(max(x, a), b)
                            for s, t, *_ in over for x in (s, t)})
    share: dict = {}
    for lo, hi in zip(cuts, cuts[1:]):
        if hi <= lo:
            continue
        mid = 0.5 * (lo + hi)
        inner = max((iv for iv in over if iv[0] <= mid < iv[1]),
                    key=lambda iv: iv[3], default=None)
        name = inner[2] if inner is not None else "host"
        share[name] = share.get(name, 0.0) + (hi - lo)
    best = max(share, key=share.get) if share else "host"
    return best, share


def name_gaps(doc: dict, rec, top: int = 10) -> list[tuple]:
    """The ``top`` longest device-idle gaps as (µs, name, {name: µs})."""
    spans = span_intervals(doc, rec) if rec is not None else []
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
               e["name"]) for e in _events(doc)
              if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("perfbench.")]
    out = []
    for a, b in device_gaps(doc)[:top]:
        name, share = name_gap(a, b, spans, ranges)
        out.append((b - a, name, share))
    return out


def count_copies(doc: dict) -> int:
    """Host-device copies on the device (``Memcpy HtoD`` / ``DtoH``) whose
    host call lies outside the benchmark's restore, digest and collection
    ranges."""
    events = _events(doc)
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                    for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") in OUTSIDE)
    starts = [r[0] for r in ranges]
    host = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") == "cuda_runtime" and corr is not None:
            host[corr] = float(e["ts"])
    n = 0
    for e in events:
        name = str(e.get("name", ""))
        if e.get("cat") != "gpu_memcpy" or not (
                "HtoD" in name or "DtoH" in name):
            continue
        ts = host.get((e.get("args") or {}).get("correlation"),
                      float(e["ts"]))
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts < ranges[i][1]:
            continue
        n += 1
    return n


def report(path: str, rec) -> list[str]:
    """Lines for standard error: the named gaps and the copies' closure."""
    with open(path) as f:
        doc = json.load(f)
    lines = []
    for i, (us, name, share) in enumerate(name_gaps(doc, rec)):
        parts = ", ".join(f"{n} {v / 1e3:.3f}" for n, v in
                          sorted(share.items(), key=lambda kv: -kv[1])[:4])
        lines.append(f"spans: idle gap {i}: {us / 1e3:.3f} ms, {name} "
                     f"({parts} ms)")
    if rec is not None:
        c = rec.counters
        ours = c.get("device.h2d_copies", 0) + c.get("device.d2h_copies", 0)
        lines.append(f"spans: copies counted {ours}, the profiler's outside "
                     f"{'/'.join(OUTSIDE)} {count_copies(doc)}")
        if rec.dropped:
            lines.append(f"spans: {rec.dropped} events past the cap")
    return lines


def closure(metrics: dict, rec, passes: int) -> list[str]:
    """The spans against the benchmark's outside timers, a pass each."""
    if rec is None or not passes:
        return ["spans: no recorder in this run"]
    t = rec.totals

    def ms(*names, k=2):
        return sum(t[n][k] for n in names if n in t) / 1e6 / passes

    def val(name):
        return metrics.get(name, {}).get("value", 0.0)

    walls = sum(val(n) for n in ("engine.self_ms_per_pass",
                                 "prioritizer.rank_ms_per_pass",
                                 "placement.placed_ms_per_pass",
                                 "predictor.ms_per_pass"))
    rank = ms("rltune.rank.features", "rltune.rank.actor", "rltune.rank.tail",
              "rltune.rank")
    pred = ms("rltune.predict.rows", "rltune.predict.forward",
              "rltune.predict.sgd", "rltune.predict.submit")
    lines = [
        f"spans: self times {ms(*t):.6f} ms a pass, pass walls "
        f"{walls:.6f} ({100 * (ms(*t) / walls - 1) if walls else 0:+.2f}%)",
        f"spans: features + actor + tail + rank self {rank:.6f} ms a pass, "
        "prioritizer.rank_ms_per_pass "
        f"{val('prioritizer.rank_ms_per_pass'):.6f}",
        f"spans: rows + submit + forward + sgd {pred:.6f} ms a pass, "
        f"predictor.ms_per_pass {val('predictor.ms_per_pass'):.6f}"]
    for n in sorted(t, key=lambda n: -t[n][2]):
        lines.append(f"spans: {n}: {t[n][0]} calls, wall {t[n][1] / 1e6:.3f}"
                     f" ms, self {t[n][2] / 1e6:.3f} ms "
                     f"({t[n][2] / 1e6 / passes:.6f} ms a pass)")
    lines.append("spans: counters " + json.dumps(rec.counters,
                                                 sort_keys=True))
    return lines


def main(argv=None) -> int:
    """A ``--trace 1`` run of ``perfbench.run`` that also names the idle
    gaps by program span and prints the closure on standard error."""
    from perfbench import run, trace_reader

    read0, measure0 = trace_reader.read, run.measure
    notes, kept = [], {}

    def read(path):
        notes.extend(report(path, recorder()))
        return read0(path)

    def measure(*args, **kw):
        result, n = measure0(*args, **kw)
        kept["result"] = result
        return result, n

    trace_reader.read, run.measure = read, measure
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--trace" not in argv:
        argv += ["--trace", "1"]
    try:
        rc = run.main(argv)
    finally:
        trace_reader.read, run.measure = read0, measure0
    res = kept.get("result")
    if res is not None:
        notes += closure(res["metrics"], recorder(), res["attempted"])
    for line in notes:
        print(line, file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())

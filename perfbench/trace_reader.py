"""Reading a ``torch.profiler`` trace of the window: device time by kernel
name, the union of device intervals (busy time), and the longest gaps in
it, each named by the benchmark's host range (``perfbench.*``) that covers
most of it."""
from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read(path: str) -> dict:
    """{"busy_s", "span_s", "by_name": {name: (seconds, count)},
    "ops": [[name, seconds]] (top 10), "gaps": [[name, seconds]] (top 10)}
    from a chrome trace exported by ``torch.profiler``."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, ranges = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", "")))
        elif cat == "user_annotation" and \
                str(e.get("name", "")).startswith("perfbench."):
            ranges.append((ts, ts + dur, e["name"]))
    by_name: dict = {}
    for s, t, n in dev:
        sec, cnt = by_name.get(n, (0.0, 0))
        by_name[n] = (sec + (t - s) * 1e-6, cnt + 1)
    dev.sort()
    busy, gaps = 0.0, []
    cur_s = cur_t = None
    for s, t, _ in dev:
        if cur_t is None:
            cur_s, cur_t = s, t
        elif s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += cur_t - cur_s
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [[_cover(ranges, a, b), (b - a) * 1e-6] for a, b in gaps[:10]]
    ops = sorted(([n, v[0]] for n, v in by_name.items()),
                 key=lambda x: -x[1])[:10]
    return {"busy_s": busy * 1e-6, "by_name": by_name, "ops": ops,
            "gaps": named}


def _cover(ranges: list, a: float, b: float) -> str:
    """The name whose ranges overlap [a, b] the most ("host" if none);
    nested ranges count for the innermost name only where they lie."""
    share: dict = {}
    for s, t, n in ranges:
        o = min(b, t) - max(a, s)
        if o > 0:
            share[n] = share.get(n, 0.0) + o
    if not share:
        return "host"
    return max(share, key=share.get)


def kernel_time(by_name: dict, needle: str) -> tuple[float, int]:
    """Seconds and launches of the device kernels whose name holds
    ``needle``."""
    sec = sum(v[0] for n, v in by_name.items() if needle in n)
    cnt = sum(v[1] for n, v in by_name.items() if needle in n)
    return sec, cnt

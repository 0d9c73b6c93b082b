"""Streaming engine benchmark on the port: sustained jobs/sec and decision
latency on >=10k-job continuous streams (the paper's Sec. 3.1.2 service
mode at scale).

The analog of ``benchmarks/bench_streaming.py`` on ``repro_torch``.
Measures, per scenario and queue window:
- end-to-end simulated-stream throughput (completed jobs per wall-second)
- mean / p99 scheduler decision latency (wall time per rank call, the
  quantity a 1-minute Slurm rescan loop must stay under)
- rolling-telemetry summary (utilization, p99 queueing delay, peak queue)

A deep-queue point (flash-crowd @ queue_window=4096) tracks how decision
latency grows with window size; the growth must stay sub-linear.  FCFS +
``pack`` on the host: no tensor and no kernel.  Results go to
``benchmarks_torch/BENCH_streaming.json`` with the reference's fields,
including ``speedup_vs_pre_pr`` against ``PRE_PR_LAT_MEAN_MS``, which was
timed on the reference's CI container: an informational ratio against
another host's baseline, never a gate.

REPRO_BENCH_SCALE=full streams 20k jobs; default (quick) streams 10k;
REPRO_BENCH_STREAM_JOBS overrides the count.  ``--device`` (or
REPRO_BENCH_DEVICE) is recorded in the provenance.

    PYTHONPATH=src python -m benchmarks_torch.bench_streaming [--device cpu]
"""
from __future__ import annotations

import os
import platform

import numpy as np

from benchmarks_torch.common import (DecisionTimer, device_main, drive_stream,
                                     provenance, rounded, write_json)
from repro_torch.core import PolicyPrioritizer, make_policy
from repro_torch.sched import RollingTelemetry, SchedulerEngine, get_scenario

SCALE = os.environ.get("REPRO_BENCH_SCALE", "quick")
NUM_JOBS = int(os.environ.get("REPRO_BENCH_STREAM_JOBS",
                              {"quick": 10_000, "full": 20_000}[SCALE]))
SCENARIOS = ("steady", "diurnal", "flash-crowd")
QUEUE_WINDOWS = (256, 1024)
#: deep-queue congestion point: decision latency must grow sub-linearly in
#: the window size (compare against the qw=1024 row of the same scenario)
DEEP_QUEUE = ("flash-crowd", 4096)
JSON_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "BENCH_streaming.json")

#: the reference's mean decision latency of its pre-optimization engine,
#: timed on its CI container at quick scale (10k jobs, FCFS+pack): kept so
#: the record stays comparable field for field with the reference's
PRE_PR_LAT_MEAN_MS = {
    "steady/qw256": 0.13, "steady/qw1024": 0.27,
    "diurnal/qw256": 0.09, "diurnal/qw1024": 0.27,
    "flash-crowd/qw256": 0.11, "flash-crowd/qw1024": 0.31,
}


def stream_once(scenario: str, queue_window: int) -> dict:
    run = get_scenario(scenario).build(NUM_JOBS, seed=0)
    pri = DecisionTimer(PolicyPrioritizer(make_policy("fcfs")))
    tel = RollingTelemetry(window=6 * 3600.0, sample_interval=3600.0)
    engine = SchedulerEngine(run.spec, pri, allocator="pack",
                             fault_model=run.fault_model,
                             queue_window=queue_window, hooks=(tel,))
    wall = drive_stream(engine, [j.clone_pending() for j in run.jobs])
    tel.final(engine)
    lat = np.array(pri.lat) if pri.lat else np.zeros(1)
    util = [s.utilization for s in tel.samples]
    return {
        "completed": len(engine.completed),
        "wall_s": wall,
        "jobs_per_s": len(engine.completed) / max(wall, 1e-9),
        "decisions": engine.decisions,
        "lat_mean_ms": 1e3 * float(lat.mean()),
        "lat_p99_ms": 1e3 * float(np.percentile(lat, 99)),
        "util_mean": float(np.mean(util)) if util else 0.0,
        "wait_p99_h": tel.worst_wait_p99() / 3600.0,
        "peak_queue": tel.peak_queue_len(),
    }


def _emit_json(results: dict[str, dict]) -> dict:
    speedup = {}
    if NUM_JOBS == 10_000:   # baseline was recorded at quick scale
        for key, base_ms in PRE_PR_LAT_MEAN_MS.items():
            if key in results and results[key]["lat_mean_ms"] > 0:
                speedup[key] = round(base_ms / results[key]["lat_mean_ms"], 2)
    deep_key = f"{DEEP_QUEUE[0]}/qw{DEEP_QUEUE[1]}"
    ref_qw = QUEUE_WINDOWS[-1]
    ref_key = f"{DEEP_QUEUE[0]}/qw{ref_qw}"
    growth = None
    if deep_key in results and ref_key in results \
            and results[ref_key]["lat_mean_ms"] > 0:
        ratio = results[deep_key]["lat_mean_ms"] / results[ref_key]["lat_mean_ms"]
        growth = {
            "ref_queue_window": ref_qw,
            "window_ratio": DEEP_QUEUE[1] / ref_qw,
            "latency_ratio": round(ratio, 3),
            "sublinear": bool(ratio < DEEP_QUEUE[1] / ref_qw),
        }
    doc = {
        "bench": "streaming",
        "scale": SCALE,
        "num_jobs": NUM_JOBS,
        "policy": "fcfs",
        "allocator": "pack",
        "host": platform.node() or "unknown",
        "machine": platform.machine(),
        "baseline_host_note": "PRE_PR_LAT_MEAN_MS measured on the original "
                              "CI container at quick scale; compare "
                              "speedup_vs_pre_pr only on matching hardware",
        "results": {k: rounded(r) for k, r in results.items()},
        "pre_pr_baseline_lat_mean_ms": PRE_PR_LAT_MEAN_MS,
        "speedup_vs_pre_pr": speedup,
        "deep_queue_latency_growth": growth,
        "provenance": provenance(seed=0, host_only=True),
    }
    write_json(JSON_PATH, doc)
    return doc


def run(out: list[str] | None = None) -> dict:
    print(f"# streaming engine: {NUM_JOBS} jobs/stream, FCFS+pack, "
          f"1h ingest chunks")
    print(f"{'scenario':12s} {'qwin':>5s} {'jobs/s':>8s} {'dec':>7s} "
          f"{'lat.mean':>9s} {'lat.p99':>8s} {'util':>5s} {'waitP99h':>8s} "
          f"{'peakQ':>6s} {'wall(s)':>8s}")
    grid = [(sc, qw) for sc in SCENARIOS for qw in QUEUE_WINDOWS]
    grid.append(DEEP_QUEUE)
    results: dict[str, dict] = {}
    for scenario, qw in grid:
        r = stream_once(scenario, qw)
        assert r["completed"] == NUM_JOBS, (scenario, qw, r["completed"])
        results[f"{scenario}/qw{qw}"] = r
        print(f"{scenario:12s} {qw:5d} {r['jobs_per_s']:8.0f} "
              f"{r['decisions']:7d} {r['lat_mean_ms']:7.2f}ms "
              f"{r['lat_p99_ms']:6.2f}ms {r['util_mean']:5.2f} "
              f"{r['wait_p99_h']:8.1f} {r['peak_queue']:6d} "
              f"{r['wall_s']:8.1f}")
        if out is not None:
            out.append(f"streaming/{scenario}/qw{qw}/lat_ms,"
                       f"{r['lat_mean_ms']:.3f},"
                       f"{r['jobs_per_s']:.0f} jobs/s")
    doc = _emit_json(results)
    print(f"# wrote {os.path.normpath(JSON_PATH)}")
    if doc["speedup_vs_pre_pr"]:
        pretty = ", ".join(f"{k} {v:.1f}x"
                           for k, v in sorted(doc["speedup_vs_pre_pr"].items()))
        print(f"# decision-latency speedup vs pre-PR baseline (another "
              f"host's): {pretty}")
    if doc["deep_queue_latency_growth"] is not None:
        g = doc["deep_queue_latency_growth"]
        print(f"# deep-queue growth {DEEP_QUEUE[0]} "
              f"qw{g['ref_queue_window']}->qw{DEEP_QUEUE[1]}: "
              f"latency x{g['latency_ratio']:.2f} over window x{g['window_ratio']:.0f} "
              f"({'sub-linear' if g['sublinear'] else 'SUPER-linear'})")
    return doc


if __name__ == "__main__":
    device_main(run, __doc__)

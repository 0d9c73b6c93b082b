"""Autoscaling benchmark on the port: elastic capacity vs. a static
peak-provisioned cluster (the analog of ``benchmarks/bench_autoscaling.py``
on ``repro_torch``).

Streams the congestion scenarios with shaped supply pressure (``diurnal``
day/night swings, ``flash-crowd`` spike) through ``run_scenario`` three
ways — static capacity (the baseline every prior PR measured), the
``target-util`` hysteresis controller, and the ``queue-pressure`` dual-
watermark controller — and compares *provisioned* GPU-hours (the integral
of non-retired capacity over simulated time, i.e. what an elastic
deployment pays for) against schedule quality (worst rolling wait-p99).

Acceptance (recorded in ``benchmarks_torch/BENCH_autoscaling.json``): on both scenarios the
hysteresis ``target-util`` controller must cut provisioned GPU-hours vs.
static peak capacity while holding worst wait-p99 inside the documented
band ``<= WAIT_BAND_FACTOR * static + WAIT_BAND_SLACK_S``.  The
disabled-autoscaler bit-identity pin (autoscaler=None == pre-autoscaling
engine on every registered scenario, single-cluster and 1-member
federation) is held on the port by ``tests/test_torch_scale.py``.

Modes: REPRO_BENCH_SCALE=full streams 10k jobs, default (quick) 3k;
``--smoke`` caps at <=300.  REPRO_BENCH_AUTOSCALE_JOBS overrides the job
count, REPRO_BENCH_AUTOSCALE_JSON the artifact path.  FCFS + ``pack`` on
the host: no tensor and no kernel; ``--device`` (or REPRO_BENCH_DEVICE) is
recorded in the provenance.

    PYTHONPATH=src python -m benchmarks_torch.bench_autoscaling [--smoke] [--device cpu]
"""
from __future__ import annotations

import os
import platform
import time

from benchmarks_torch.common import (device_main, provenance, rounded,
                                     write_json)
from repro_torch.scale import (QueuePressureAutoscaler,
                               TargetUtilizationAutoscaler, pools_from_spec)
from repro_torch.sched import get_scenario, run_scenario

SCALE = os.environ.get("REPRO_BENCH_SCALE", "quick")
NUM_JOBS = int(os.environ.get("REPRO_BENCH_AUTOSCALE_JOBS",
                              {"quick": 3_000, "full": 10_000}[SCALE]))
SMOKE_JOBS = 300
SCENARIOS = ("diurnal", "flash-crowd")
#: wait-p99 degradation band the elastic runs must stay inside
WAIT_BAND_FACTOR = 1.5
WAIT_BAND_SLACK_S = 1800.0
JSON_PATH = os.environ.get(
    "REPRO_BENCH_AUTOSCALE_JSON",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "BENCH_autoscaling.json"))

#: controller configurations under test (pools derived per scenario spec)
CONTROLLERS = {
    "target-util": lambda spec: TargetUtilizationAutoscaler(
        pools_from_spec(spec, min_frac=0.25),
        util_low=0.6, util_high=0.85, max_pending_for_down=4,
        cooldown_s=1800.0),
    "queue-pressure": lambda spec: QueuePressureAutoscaler(
        pools_from_spec(spec, min_frac=0.25),
        wait_up_s=1800.0, wait_down_s=300.0, util_down=0.55,
        cooldown_s=1800.0),
}


def stream_once(scenario: str, controller: str | None, num_jobs: int) -> dict:
    run = get_scenario(scenario).build(num_jobs, 0)
    autoscaler = CONTROLLERS[controller](run.spec) if controller else None
    t0 = time.perf_counter()
    sr = run_scenario(run, allocator="pack", rescan_interval=60.0,
                      sample_interval=3600.0, autoscaler=autoscaler)
    wall = time.perf_counter() - t0
    tel = sr.telemetry
    row = {
        "completed": len(sr.batch.jobs),
        "wall_s": wall,
        "jobs_per_s": len(sr.batch.jobs) / max(wall, 1e-9),
        "windows": sr.windows,
        "provisioned_gpu_h": tel.provisioned_gpu_hours,
        "used_gpu_h": tel.used_gpu_hours,
        "worst_wait_p99_h": tel.worst_wait_p99() / 3600.0,
        "avg_wait_h": sum(j.wait_time for j in sr.batch.jobs)
        / max(len(sr.batch.jobs), 1) / 3600.0,
        "utilization": sr.batch.utilization,
    }
    if autoscaler is not None:
        row["scale_events"] = autoscaler.event_counts()
        row["scale_events_total"] = len(autoscaler.events)
    return row


def _acceptance(results: dict[str, dict]) -> dict:
    """target-util vs the static baseline on every scenario."""
    out: dict = {
        "controller": "target-util",
        "wait_band": f"<= {WAIT_BAND_FACTOR} * static worst wait-p99 "
                     f"+ {WAIT_BAND_SLACK_S:.0f}s",
    }
    for scen in SCENARIOS:
        base = results.get(f"{scen}/static")
        elastic = results.get(f"{scen}/target-util")
        if base is None or elastic is None:
            continue
        key = scen.replace("-", "_")
        saved = 1.0 - elastic["provisioned_gpu_h"] \
            / max(base["provisioned_gpu_h"], 1e-9)
        band_h = (WAIT_BAND_FACTOR * base["worst_wait_p99_h"]
                  + WAIT_BAND_SLACK_S / 3600.0)
        out[f"{key}_gpu_hours_saved_frac"] = round(saved, 4)
        out[f"{key}_cuts_gpu_hours"] = bool(saved > 0.0)
        out[f"{key}_wait_p99_h"] = round(elastic["worst_wait_p99_h"], 4)
        out[f"{key}_wait_band_h"] = round(band_h, 4)
        out[f"{key}_wait_within_band"] = \
            bool(elastic["worst_wait_p99_h"] <= band_h)
    return out


def _emit_json(results: dict[str, dict], num_jobs: int, smoke: bool) -> dict:
    doc = {
        "bench": "autoscaling",
        "scale": "smoke" if smoke else SCALE,
        "num_jobs": num_jobs,
        "policy": "fcfs",
        "allocator": "pack",
        "rescan_interval_s": 60.0,
        "host": platform.node() or "unknown",
        "machine": platform.machine(),
        "results": {k: rounded(r) for k, r in results.items()},
        "acceptance": _acceptance(results),
        "provenance": provenance(seed=0, host_only=True),
    }
    write_json(JSON_PATH, doc)
    return doc


def run(out: list[str] | None = None, smoke: bool = False) -> dict:
    num_jobs = min(NUM_JOBS, SMOKE_JOBS) if smoke else NUM_JOBS
    variants = [None] + sorted(CONTROLLERS)
    print(f"# autoscaling: {num_jobs} jobs/stream, FCFS+pack, 60s rescan, "
          f"controllers={','.join(c for c in variants if c)}")
    print(f"{'scenario':14s} {'controller':14s} {'provGPUh':>9s} "
          f"{'usedGPUh':>9s} {'waitP99h':>8s} {'events':>7s} {'wall(s)':>8s}")
    results: dict[str, dict] = {}
    for scenario in SCENARIOS:
        for controller in variants:
            label = controller or "static"
            r = stream_once(scenario, controller, num_jobs)
            assert r["completed"] == num_jobs, \
                (scenario, label, r["completed"])
            results[f"{scenario}/{label}"] = r
            print(f"{scenario:14s} {label:14s} {r['provisioned_gpu_h']:9.0f} "
                  f"{r['used_gpu_h']:9.0f} {r['worst_wait_p99_h']:8.2f} "
                  f"{r.get('scale_events_total', 0):7d} {r['wall_s']:8.1f}")
            if out is not None:
                out.append(f"autoscaling/{scenario}/{label}/provisioned_gpu_h,"
                           f"{r['provisioned_gpu_h']:.1f},"
                           f"wait_p99_h {r['worst_wait_p99_h']:.2f}")
    doc = _emit_json(results, num_jobs, smoke)
    print(f"# wrote {os.path.normpath(JSON_PATH)}")
    acc = doc["acceptance"]
    for scen in SCENARIOS:
        key = scen.replace("-", "_")
        if f"{key}_cuts_gpu_hours" in acc:
            cut = "CUTS" if acc[f"{key}_cuts_gpu_hours"] else "DOES NOT CUT"
            band = "WITHIN" if acc[f"{key}_wait_within_band"] else "OUTSIDE"
            print(f"# target-util {cut} provisioned GPU-hours on {scen} "
                  f"({acc[f'{key}_gpu_hours_saved_frac']:.1%} saved), "
                  f"wait-p99 {band} band "
                  f"({acc[f'{key}_wait_p99_h']:.2f}h vs "
                  f"{acc[f'{key}_wait_band_h']:.2f}h)")
    return doc


if __name__ == "__main__":
    device_main(run, __doc__, smoke=SMOKE_JOBS)

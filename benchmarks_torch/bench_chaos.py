"""Chaos benchmark on the port: scheduler quality under injected failure
bursts (the analog of ``benchmarks/bench_chaos.py`` on ``repro_torch``).

Streams the ``chaos-storm`` scenario (helios trace + rack-scoped failure
bursts, spot-reclamation waves against the P100 pool, a straggler storm,
and organic background faults) through ``run_scenario`` two ways — chaos
off on a fault-free cluster (the clean baseline every prior PR measured)
and chaos on with a deliberately strict ``DegradationPolicy`` (zero MILP
wall-clock budget + zero window deadline) so the control-plane degradation
ladder demonstrably fires: every multi-way placement falls back to greedy
and scheduling windows drop to FCFS ordering.

Acceptance (recorded in ``benchmarks_torch/BENCH_chaos.json``): under the full storm the
worst rolling wait-p99 must stay inside
``<= WAIT_BAND_FACTOR * fault-free baseline + WAIT_BAND_SLACK_S`` and the
degradation ladder must actually activate (``milp_fallbacks > 0`` and
``degraded_windows > 0``).  The chaos-off bit-identity pin (chaos=None ==
pre-chaos engine on every registered scenario) is the reference's
(``tests/test_chaos.py``); ``tests/test_torch_control_benches.py`` holds
this bench's document to the reference's.

Modes: REPRO_BENCH_SCALE=full streams 3k jobs, default (quick) 1.2k;
``--smoke`` caps at <=300.  REPRO_BENCH_CHAOS_JOBS overrides the job
count, REPRO_BENCH_CHAOS_JSON the artifact path.  FCFS + ``milp`` on the
host: no tensor and no kernel; ``--device`` (or REPRO_BENCH_DEVICE) is
recorded in the provenance.

    PYTHONPATH=src python -m benchmarks_torch.bench_chaos [--smoke] [--device cpu]
"""
from __future__ import annotations

import dataclasses
import os
import platform
import time

from benchmarks_torch.common import (device_main, provenance, rounded,
                                     write_json)
from repro_torch.chaos import DegradationPolicy
from repro_torch.sched import get_scenario, run_scenario

SCALE = os.environ.get("REPRO_BENCH_SCALE", "quick")
NUM_JOBS = int(os.environ.get("REPRO_BENCH_CHAOS_JOBS",
                              {"quick": 1_200, "full": 3_000}[SCALE]))
SMOKE_JOBS = 300
SCENARIO = "chaos-storm"
#: wait-p99 band the chaos run must stay inside vs the fault-free baseline
WAIT_BAND_FACTOR = 2.0
WAIT_BAND_SLACK_S = 1800.0
JSON_PATH = os.environ.get(
    "REPRO_BENCH_CHAOS_JSON",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "BENCH_chaos.json"))

#: strict ladder so fallback + FCFS degradation provably engage under storm
STRICT_DEGRADATION = DegradationPolicy(milp_budget_s=0.0, trip_after=1,
                                       reset_after_decisions=16,
                                       window_deadline_s=0.0)


def deadline_hit_rate(jobs) -> tuple[float, int]:
    """(hit rate over deadline-carrying jobs, deadline-job count)."""
    dl = [j for j in jobs if j.has_deadline]
    if not dl:
        return 1.0, 0
    hits = sum(1 for j in dl if j.finish_time <= j.deadline)
    return hits / len(dl), len(dl)


def _percentile(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    i = min(len(xs) - 1, int(round(q * (len(xs) - 1))))
    return xs[i]


def stream_once(chaos_on: bool, num_jobs: int) -> dict:
    run = get_scenario(SCENARIO).build(num_jobs, 0)
    if chaos_on:
        kwargs = {"degradation": STRICT_DEGRADATION}
    else:
        # the clean arm: no injected chaos AND no organic background faults
        run = dataclasses.replace(run, fault_model=None, chaos=None)
        kwargs = {"chaos": False}
    t0 = time.perf_counter()
    sr = run_scenario(run, allocator="milp", rescan_interval=60.0,
                      sample_interval=3600.0, **kwargs)
    wall = time.perf_counter() - t0
    tel = sr.telemetry
    eng = sr.engine
    hit, n_dl = deadline_hit_rate(sr.batch.jobs)
    jcts = [j.finish_time - j.submit_time for j in sr.batch.jobs]
    row = {
        "completed": len(sr.batch.jobs),
        "wall_s": wall,
        "jobs_per_s": len(sr.batch.jobs) / max(wall, 1e-9),
        "windows": sr.windows,
        "jct_p50_h": _percentile(jcts, 0.50) / 3600.0,
        "jct_p99_h": _percentile(jcts, 0.99) / 3600.0,
        "worst_wait_p99_h": tel.worst_wait_p99() / 3600.0,
        "deadline_jobs": n_dl,
        "deadline_hit_rate": hit,
        "utilization": sr.batch.utilization,
        "restarts": eng.restarts,
        "preemptions": eng.preemptions,
        "reclaimed_jobs": eng.reclaimed_jobs,
        "milp_fallbacks": eng.milp_fallbacks,
        "degraded_windows": eng.degraded_windows,
        "degraded_h": eng.degraded_s / 3600.0,
        "degraded_fraction": tel.degraded_fraction(),
        "peak_nodes_down": tel.peak_nodes_down(),
        "chaos_events": len(tel.chaos_events),
    }
    return row


def _acceptance(results: dict[str, dict]) -> dict:
    base = results.get("chaos-off")
    storm = results.get("chaos-on")
    out: dict = {
        "scenario": SCENARIO,
        "wait_band": f"<= {WAIT_BAND_FACTOR} * fault-free worst wait-p99 "
                     f"+ {WAIT_BAND_SLACK_S:.0f}s",
    }
    if base is None or storm is None:
        return out
    band_h = (WAIT_BAND_FACTOR * base["worst_wait_p99_h"]
              + WAIT_BAND_SLACK_S / 3600.0)
    out["wait_p99_off_h"] = round(base["worst_wait_p99_h"], 4)
    out["wait_p99_on_h"] = round(storm["worst_wait_p99_h"], 4)
    out["wait_band_h"] = round(band_h, 4)
    out["wait_within_band"] = bool(storm["worst_wait_p99_h"] <= band_h)
    out["milp_fallbacks"] = storm["milp_fallbacks"]
    out["ladder_fired"] = bool(storm["milp_fallbacks"] > 0
                               and storm["degraded_windows"] > 0)
    out["hit_rate_off"] = round(base["deadline_hit_rate"], 4)
    out["hit_rate_on"] = round(storm["deadline_hit_rate"], 4)
    return out


def _emit_json(results: dict[str, dict], num_jobs: int, smoke: bool) -> dict:
    doc = {
        "bench": "chaos",
        "scale": "smoke" if smoke else SCALE,
        "num_jobs": num_jobs,
        "scenario": SCENARIO,
        "policy": "fcfs",
        "allocator": "milp",
        "rescan_interval_s": 60.0,
        "degradation": dataclasses.asdict(STRICT_DEGRADATION),
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
    print(f"# chaos: {num_jobs} jobs/stream on {SCENARIO}, FCFS+milp, "
          f"60s rescan, strict degradation ladder on the chaos arm")
    print(f"{'arm':10s} {'waitP99h':>8s} {'jctP99h':>8s} {'hitRate':>8s} "
          f"{'reclaim':>8s} {'fallbks':>8s} {'degWin':>7s} {'wall(s)':>8s}")
    results: dict[str, dict] = {}
    for label, chaos_on in (("chaos-off", False), ("chaos-on", True)):
        r = stream_once(chaos_on, num_jobs)
        assert r["completed"] == num_jobs, (label, r["completed"])
        results[label] = r
        print(f"{label:10s} {r['worst_wait_p99_h']:8.2f} "
              f"{r['jct_p99_h']:8.2f} {r['deadline_hit_rate']:8.3f} "
              f"{r['reclaimed_jobs']:8d} {r['milp_fallbacks']:8d} "
              f"{r['degraded_windows']:7d} {r['wall_s']:8.1f}")
        if out is not None:
            out.append(f"chaos/{SCENARIO}/{label}/wait_p99_h,"
                       f"{r['worst_wait_p99_h']:.4f},"
                       f"jct_p99_h {r['jct_p99_h']:.2f}")
    doc = _emit_json(results, num_jobs, smoke)
    print(f"# wrote {os.path.normpath(JSON_PATH)}")
    acc = doc["acceptance"]
    if "wait_within_band" in acc:
        band = "WITHIN" if acc["wait_within_band"] else "OUTSIDE"
        fired = "FIRED" if acc["ladder_fired"] else "DID NOT FIRE"
        print(f"# chaos wait-p99 {band} band "
              f"({acc['wait_p99_on_h']:.2f}h vs {acc['wait_band_h']:.2f}h "
              f"allowed); degradation ladder {fired} "
              f"({acc['milp_fallbacks']} MILP fallbacks)")
    return doc


if __name__ == "__main__":
    device_main(run, __doc__, smoke=SMOKE_JOBS)

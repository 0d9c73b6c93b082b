"""Preemption benchmark on the port: SLO-lane deadline enforcement vs.
run-to-completion (the analog of ``benchmarks/bench_preemption.py`` on
``repro_torch``).

Streams the ``slo-lanes`` deadline storm (congestion spike + ~30% hard-
deadline jobs + elastic gangs) through ``run_scenario`` three ways — no
lifecycle controller (the run-to-completion baseline every prior PR
measured), the ``SloDeadlinePolicy`` alone, and the full controller
(SLO eviction + elastic grow/shrink) — and compares **deadline hit-rate**
(fraction of deadline-carrying jobs finishing by their deadline) against
overall schedule quality (worst rolling wait-p99) and the checkpoint-
restore overhead actually paid (resume-penalty GPU-hours).

Acceptance (recorded in ``benchmarks_torch/BENCH_preemption.json``): the SLO-lane policy
must *improve* deadline hit-rate over the preemption-off baseline on the
congested scenario while keeping worst wait-p99 inside the documented band
``<= WAIT_BAND_FACTOR * baseline + WAIT_BAND_SLACK_S`` (best-effort work
legitimately waits longer when deadline work evicts it — the band caps how
much).  The preemption-off bit-identity pin (preemption=None == pre-
lifecycle engine on every registered scenario) is held on the port by
``tests/test_torch_lifecycle.py``.

Modes: REPRO_BENCH_SCALE=full streams 6k jobs, default (quick) 2k;
``--smoke`` caps at <=300.  REPRO_BENCH_PREEMPT_JOBS overrides the job
count, REPRO_BENCH_PREEMPT_JSON the artifact path.  FCFS + ``pack`` on the
host: no tensor and no kernel; ``--device`` (or REPRO_BENCH_DEVICE) is
recorded in the provenance.

    PYTHONPATH=src python -m benchmarks_torch.bench_preemption [--smoke] [--device cpu]
"""
from __future__ import annotations

import os
import platform
import time

from benchmarks_torch.common import (device_main, provenance, rounded,
                                     write_json)
from repro_torch.lifecycle import (ElasticGangPolicy, PreemptionController,
                                   SloDeadlinePolicy)
from repro_torch.sched import get_scenario, run_scenario

SCALE = os.environ.get("REPRO_BENCH_SCALE", "quick")
NUM_JOBS = int(os.environ.get("REPRO_BENCH_PREEMPT_JOBS",
                              {"quick": 2_000, "full": 6_000}[SCALE]))
SMOKE_JOBS = 300
SCENARIOS = ("slo-lanes",)
#: wait-p99 degradation band the preemptive runs must stay inside
WAIT_BAND_FACTOR = 1.5
WAIT_BAND_SLACK_S = 1800.0
JSON_PATH = os.environ.get(
    "REPRO_BENCH_PREEMPT_JSON",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "BENCH_preemption.json"))

#: controller configurations under test (fresh per stream — controllers
#: accumulate event logs)
CONTROLLERS = {
    "slo": lambda: PreemptionController([SloDeadlinePolicy()]),
    "slo+elastic": lambda: PreemptionController(
        [SloDeadlinePolicy(), ElasticGangPolicy()]),
}


def deadline_hit_rate(jobs) -> tuple[float, int]:
    """(hit rate over deadline-carrying jobs, deadline-job count)."""
    dl = [j for j in jobs if j.has_deadline]
    if not dl:
        return 1.0, 0
    hits = sum(1 for j in dl if j.finish_time <= j.deadline)
    return hits / len(dl), len(dl)


def stream_once(scenario: str, controller: str | None, num_jobs: int) -> dict:
    run = get_scenario(scenario).build(num_jobs, 0)
    ctl = CONTROLLERS[controller]() if controller else None
    t0 = time.perf_counter()
    sr = run_scenario(run, allocator="pack", rescan_interval=60.0,
                      sample_interval=3600.0, preemption=ctl)
    wall = time.perf_counter() - t0
    tel = sr.telemetry
    hit, n_dl = deadline_hit_rate(sr.batch.jobs)
    row = {
        "completed": len(sr.batch.jobs),
        "wall_s": wall,
        "jobs_per_s": len(sr.batch.jobs) / max(wall, 1e-9),
        "windows": sr.windows,
        "deadline_jobs": n_dl,
        "deadline_hit_rate": hit,
        "worst_wait_p99_h": tel.worst_wait_p99() / 3600.0,
        "avg_wait_h": sum(j.wait_time for j in sr.batch.jobs)
        / max(len(sr.batch.jobs), 1) / 3600.0,
        "utilization": sr.batch.utilization,
        "preemptions": sr.engine.preemptions,
        "resume_penalty_gpu_h": tel.resume_penalty_gpu_hours,
    }
    if ctl is not None:
        row["lifecycle_events"] = ctl.event_counts()
    return row


def _acceptance(results: dict[str, dict]) -> dict:
    """SLO-lane policy vs the preemption-off baseline on every scenario."""
    out: dict = {
        "controller": "slo",
        "wait_band": f"<= {WAIT_BAND_FACTOR} * baseline worst wait-p99 "
                     f"+ {WAIT_BAND_SLACK_S:.0f}s",
    }
    for scen in SCENARIOS:
        base = results.get(f"{scen}/off")
        slo = results.get(f"{scen}/slo")
        if base is None or slo is None:
            continue
        key = scen.replace("-", "_")
        band_h = (WAIT_BAND_FACTOR * base["worst_wait_p99_h"]
                  + WAIT_BAND_SLACK_S / 3600.0)
        out[f"{key}_hit_rate_off"] = round(base["deadline_hit_rate"], 4)
        out[f"{key}_hit_rate_slo"] = round(slo["deadline_hit_rate"], 4)
        out[f"{key}_improves_hit_rate"] = \
            bool(slo["deadline_hit_rate"] > base["deadline_hit_rate"])
        out[f"{key}_wait_p99_h"] = round(slo["worst_wait_p99_h"], 4)
        out[f"{key}_wait_band_h"] = round(band_h, 4)
        out[f"{key}_wait_within_band"] = \
            bool(slo["worst_wait_p99_h"] <= band_h)
    return out


def _emit_json(results: dict[str, dict], num_jobs: int, smoke: bool) -> dict:
    doc = {
        "bench": "preemption",
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
    print(f"# preemption: {num_jobs} jobs/stream, FCFS+pack, 60s rescan, "
          f"controllers={','.join(c for c in variants if c)}")
    print(f"{'scenario':12s} {'controller':12s} {'hitRate':>8s} "
          f"{'waitP99h':>8s} {'preempts':>8s} {'penGPUh':>8s} {'wall(s)':>8s}")
    results: dict[str, dict] = {}
    for scenario in SCENARIOS:
        for controller in variants:
            label = controller or "off"
            r = stream_once(scenario, controller, num_jobs)
            assert r["completed"] == num_jobs, \
                (scenario, label, r["completed"])
            results[f"{scenario}/{label}"] = r
            print(f"{scenario:12s} {label:12s} {r['deadline_hit_rate']:8.3f} "
                  f"{r['worst_wait_p99_h']:8.2f} {r['preemptions']:8d} "
                  f"{r['resume_penalty_gpu_h']:8.2f} {r['wall_s']:8.1f}")
            if out is not None:
                out.append(f"preemption/{scenario}/{label}/deadline_hit_rate,"
                           f"{r['deadline_hit_rate']:.4f},"
                           f"wait_p99_h {r['worst_wait_p99_h']:.2f}")
    doc = _emit_json(results, num_jobs, smoke)
    print(f"# wrote {os.path.normpath(JSON_PATH)}")
    acc = doc["acceptance"]
    for scen in SCENARIOS:
        key = scen.replace("-", "_")
        if f"{key}_improves_hit_rate" in acc:
            imp = "IMPROVES" if acc[f"{key}_improves_hit_rate"] \
                else "DOES NOT IMPROVE"
            band = "WITHIN" if acc[f"{key}_wait_within_band"] else "OUTSIDE"
            print(f"# slo policy {imp} deadline hit-rate on {scen} "
                  f"({acc[f'{key}_hit_rate_off']:.3f} -> "
                  f"{acc[f'{key}_hit_rate_slo']:.3f}), wait-p99 {band} band "
                  f"({acc[f'{key}_wait_p99_h']:.2f}h vs "
                  f"{acc[f'{key}_wait_band_h']:.2f}h)")
    return doc


if __name__ == "__main__":
    device_main(run, __doc__, smoke=SMOKE_JOBS)

"""Observability overhead benchmark on the port: obs-off vs obs-on
decision latency (the analog of ``benchmarks/bench_obs.py`` on
``repro_torch``).

Streams the flash-crowd scenario through the engine twice per repeat —
once bare, once with the full ``repro_torch.obs`` bundle (tracer + metrics +
audit) attached — at the deep queue window (qw=1024) where ranking cost
dominates, and reports the p99 decision-latency overhead the bundle adds.

Acceptance (tracked in ``benchmarks_torch/BENCH_obs.json``): obs-on p99 decision latency
within 5% of obs-off at qw=1024, and obs-off runs bit-identical to obs-on
(same job tuples, same decision counters — the observer must not steer).
The obs-on arm's trace + Prometheus textfile are exported into the
git-ignored ``benchmarks_torch/artifacts/`` (REPRO_BENCH_OBS_TRACE,
REPRO_BENCH_OBS_PROM redirect them; REPRO_BENCH_OBS_JSON the record).

Modes: REPRO_BENCH_SCALE=full streams 10k jobs x3 repeats; default
(quick) 6k x3; ``run(smoke=True)`` 1.2k x1.  REPRO_BENCH_OBS_JOBS and
REPRO_BENCH_OBS_REPEATS override.  FCFS + ``pack`` on the host: no tensor
and no kernel; ``--device`` (or REPRO_BENCH_DEVICE) is recorded in the
provenance.

    PYTHONPATH=src python -m benchmarks_torch.bench_obs [--device cpu]
"""
from __future__ import annotations

import os
import time

import numpy as np

from benchmarks_torch.common import (device_main, drive_stream, provenance,
                                     rounded, write_json)
from repro_torch.core import PolicyPrioritizer, make_policy
from repro_torch.obs import Observability, validate_trace
from repro_torch.sched import SchedulerEngine, get_scenario

SCALE = os.environ.get("REPRO_BENCH_SCALE", "quick")
NUM_JOBS = int(os.environ.get("REPRO_BENCH_OBS_JOBS",
                              {"quick": 6_000, "full": 10_000}[SCALE]))
SMOKE_JOBS = 1_200
REPEATS = int(os.environ.get("REPRO_BENCH_OBS_REPEATS", 3))
SCENARIO = "flash-crowd"
QUEUE_WINDOW = 1024
P99_OVERHEAD_BOUND = 0.05

_HERE = os.path.dirname(os.path.abspath(__file__))
JSON_PATH = os.environ.get(
    "REPRO_BENCH_OBS_JSON",
    os.path.join(_HERE, "BENCH_obs.json"))
TRACE_PATH = os.environ.get(
    "REPRO_BENCH_OBS_TRACE",
    os.path.join(_HERE, "artifacts", "obs_trace.json"))
PROM_PATH = os.environ.get(
    "REPRO_BENCH_OBS_PROM",
    os.path.join(_HERE, "artifacts", "obs_metrics.prom"))


def _portable(path: str) -> str:
    """Repo-relative form for the committed JSON (absolute when outside)."""
    root = os.path.normpath(os.path.join(_HERE, os.pardir))
    p = os.path.normpath(path)
    return os.path.relpath(p, root) if p.startswith(root + os.sep) else p


class _TimedEngine(SchedulerEngine):
    """Times the whole scheduling pass — rank + placement + (when obs is
    attached) audit/trace emission — so the overhead figure charges the
    observability layer everything it actually adds to a decision."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.pass_lat: list[float] = []

    def _try_schedule(self) -> None:
        t0 = time.perf_counter()
        super()._try_schedule()
        self.pass_lat.append(time.perf_counter() - t0)


def _signature(engine) -> tuple:
    jobs = tuple(sorted(
        (j.job_id, round(j.submit_time, 6),
         round(j.first_start_time if j.first_start_time is not None else -1.0, 6),
         round(j.finish_time if j.finish_time is not None else -1.0, 6),
         j.restarts)
        for j in engine.completed))
    return jobs, (engine.decisions, engine.milp_calls, engine.backfills,
                  engine.restarts)


def stream_once(num_jobs: int, obs: Observability | None) -> dict:
    run = get_scenario(SCENARIO).build(num_jobs, seed=0)
    pri = PolicyPrioritizer(make_policy("fcfs"))
    hooks = tuple(obs.hooks()) if obs is not None else ()
    engine = _TimedEngine(run.spec, pri, allocator="pack",
                          fault_model=run.fault_model,
                          queue_window=QUEUE_WINDOW, hooks=hooks)
    wall = drive_stream(engine, [j.clone_pending() for j in run.jobs])
    if obs is not None:
        obs.finalize(engine)
    lat = np.array(engine.pass_lat) if engine.pass_lat else np.zeros(1)
    return {
        "completed": len(engine.completed),
        "decisions": engine.decisions,
        "wall_s": wall,
        "lat_mean_ms": 1e3 * float(lat.mean()),
        "lat_p99_ms": 1e3 * float(np.percentile(lat, 99)),
        "signature": _signature(engine),
    }


def _emit_json(num_jobs: int, repeats: list[dict], best_off: dict,
               best_on: dict, overhead: float, identical: bool,
               trace_events: int, smoke: bool) -> dict:
    doc = {
        "bench": "obs",
        "scale": "smoke" if smoke else SCALE,
        "num_jobs": num_jobs,
        "scenario": SCENARIO,
        "policy": "fcfs",
        "allocator": "pack",
        "queue_window": QUEUE_WINDOW,
        "repeats": [rounded({k: v for k, v in r.items() if k != "signature"})
                    for r in repeats],
        # min-p99 per arm across repeats: the least-noise estimate on a
        # shared CPU container; single repeats compare 1:1
        "p99_off_ms": round(best_off["lat_p99_ms"], 4),
        "p99_on_ms": round(best_on["lat_p99_ms"], 4),
        "mean_off_ms": round(best_off["lat_mean_ms"], 4),
        "mean_on_ms": round(best_on["lat_mean_ms"], 4),
        "p99_overhead": round(overhead, 4),
        "trace_events": trace_events,
        "trace_path": _portable(TRACE_PATH),
        "prom_path": _portable(PROM_PATH),
        "acceptance": {
            "p99_overhead_bound": P99_OVERHEAD_BOUND,
            "within_bound": bool(overhead <= P99_OVERHEAD_BOUND),
            "obs_off_bit_identical": bool(identical),
            "passed": bool(overhead <= P99_OVERHEAD_BOUND and identical),
        },
        "provenance": provenance(seed=0, host_only=True),
    }
    write_json(JSON_PATH, doc)
    return doc


def run(out: list[str] | None = None, smoke: bool = False) -> dict:
    num_jobs = SMOKE_JOBS if smoke else NUM_JOBS
    n_rep = 1 if smoke else REPEATS
    print(f"# obs overhead: {num_jobs} jobs on {SCENARIO}, FCFS+pack, "
          f"qw={QUEUE_WINDOW}, {n_rep} repeat(s) per arm")
    print(f"{'arm':8s} {'rep':>3s} {'decisions':>9s} {'lat.mean':>9s} "
          f"{'lat.p99':>8s} {'wall(s)':>8s}")
    repeats: list[dict] = []
    offs: list[dict] = []
    ons: list[dict] = []
    last_obs = None
    for rep in range(n_rep):
        for arm in ("off", "on"):
            obs = Observability(name="bench") if arm == "on" else None
            r = stream_once(num_jobs, obs)
            assert r["completed"] == num_jobs, (arm, rep, r["completed"])
            r["arm"] = arm
            r["rep"] = rep
            (ons if arm == "on" else offs).append(r)
            repeats.append(r)
            if obs is not None:
                last_obs = obs
            print(f"{arm:8s} {rep:3d} {r['decisions']:9d} "
                  f"{r['lat_mean_ms']:7.3f}ms {r['lat_p99_ms']:6.3f}ms "
                  f"{r['wall_s']:8.1f}")

    identical = all(r["signature"] == offs[0]["signature"] for r in repeats)
    best_off = min(offs, key=lambda r: r["lat_p99_ms"])
    best_on = min(ons, key=lambda r: r["lat_p99_ms"])
    overhead = (best_on["lat_p99_ms"] / max(best_off["lat_p99_ms"], 1e-9)
                ) - 1.0

    doc_trace = last_obs.trace_document()
    problems = validate_trace(doc_trace)
    assert not problems, f"trace schema violations: {problems[:3]}"
    os.makedirs(os.path.dirname(TRACE_PATH), exist_ok=True)
    last_obs.export_trace(TRACE_PATH)
    last_obs.write_prometheus(PROM_PATH)

    doc = _emit_json(num_jobs, repeats, best_off, best_on, overhead,
                     identical, len(doc_trace["traceEvents"]), smoke)
    print(f"# wrote {os.path.normpath(JSON_PATH)}")
    print(f"# trace artifact {os.path.normpath(TRACE_PATH)} "
          f"({len(doc_trace['traceEvents'])} events, schema OK)")
    print(f"# prometheus artifact {os.path.normpath(PROM_PATH)}")
    print(f"# p99 overhead {100 * overhead:+.1f}% "
          f"(bound {100 * P99_OVERHEAD_BOUND:.0f}%), "
          f"bit-identical={identical} -> "
          f"{'PASS' if doc['acceptance']['passed'] else 'FAIL'}")
    if out is not None:
        out.append(f"obs/{SCENARIO}/qw{QUEUE_WINDOW}/p99_overhead,"
                   f"{1e3 * overhead:.1f},"
                   f"on {best_on['lat_p99_ms']:.3f}ms vs "
                   f"off {best_off['lat_p99_ms']:.3f}ms")
    return doc


if __name__ == "__main__":
    device_main(run, __doc__)

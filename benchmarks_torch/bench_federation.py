"""Federation benchmark on the port: routing policies over heterogeneous
GPU fleets (the analog of ``benchmarks/bench_federation.py`` on
``repro_torch``).

Streams >=10k-job fleet scenarios through ``FederatedScheduler`` (one
engine per cluster, lockstep rescan windows) once per registered router and
compares fleet-level outcomes — JCT p50/p99, queueing-delay p99, fleet
utilization, cross-cluster Jain fairness, and the routed-job distribution.

The headline comparison is on the 3-cluster size-skewed fleet
(``fleet-skewed-flash``): a uniform stateless ``hash`` baseline drowns the
small cluster, so load-aware (``jsq``) and SKU-aware (``sku-affinity``)
routing must beat it on fleet wait-p99.  The verdicts are recorded in the
``acceptance`` block of ``benchmarks_torch/BENCH_federation.json``.

Modes: REPRO_BENCH_SCALE=full streams 20k jobs, default (quick) 10k;
``--smoke`` (or ``run(smoke=True)``) caps the stream at <=1k jobs.
REPRO_BENCH_FED_JOBS overrides the job count, REPRO_BENCH_FED_JSON the
artifact path.  FCFS + ``pack`` on the host: no tensor and no kernel;
``--device`` (or REPRO_BENCH_DEVICE) is recorded in the provenance.

    PYTHONPATH=src python -m benchmarks_torch.bench_federation [--smoke] [--device cpu]
"""
from __future__ import annotations

import os
import platform
import time

from benchmarks_torch.common import (device_main, provenance, rounded,
                                     write_json)
from repro_torch.fed import list_routers, run_fleet

SCALE = os.environ.get("REPRO_BENCH_SCALE", "quick")
NUM_JOBS = int(os.environ.get("REPRO_BENCH_FED_JOBS",
                              {"quick": 10_000, "full": 20_000}[SCALE]))
SMOKE_JOBS = 1_000
SCENARIOS = ("fleet-skewed-flash", "fleet-sku-split")
#: the acceptance comparison runs on the size-skewed fleet
ACCEPTANCE_SCENARIO = "fleet-skewed-flash"
JSON_PATH = os.environ.get(
    "REPRO_BENCH_FED_JSON",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "BENCH_federation.json"))


def stream_once(scenario: str, router: str, num_jobs: int) -> dict:
    t0 = time.perf_counter()
    sr = run_fleet(scenario, num_jobs=num_jobs, seed=0, router=router,
                   allocator="pack", rescan_interval=60.0,
                   sample_interval=3600.0)
    wall = time.perf_counter() - t0
    res = sr.result
    return {
        "completed": len(res.jobs),
        "wall_s": wall,
        "jobs_per_s": len(res.jobs) / max(wall, 1e-9),
        "windows": sr.windows,
        "routed": list(res.routed),
        "jct_p50_h": res.jct_p50 / 3600.0,
        "jct_p99_h": res.jct_p99 / 3600.0,
        "wait_p50_h": res.wait_p50 / 3600.0,
        "wait_p99_h": res.wait_p99 / 3600.0,
        "avg_wait_h": res.avg_wait / 3600.0,
        "utilization": res.utilization,
        "fairness": res.fairness,
    }


def _acceptance(results: dict[str, dict]) -> dict:
    """jsq / sku-affinity vs the hash baseline on the skewed fleet."""
    out: dict = {"scenario": ACCEPTANCE_SCENARIO}
    base = results.get(f"{ACCEPTANCE_SCENARIO}/hash")
    if base is None:
        return out
    for name in ("jsq", "sku-affinity"):
        r = results.get(f"{ACCEPTANCE_SCENARIO}/{name}")
        if r is None:
            continue
        key = name.replace("-", "_")
        out[f"{key}_wait_p99_h"] = round(r["wait_p99_h"], 4)
        out[f"{key}_beats_hash"] = bool(r["wait_p99_h"] < base["wait_p99_h"])
    out["hash_wait_p99_h"] = round(base["wait_p99_h"], 4)
    return out


def _emit_json(results: dict[str, dict], num_jobs: int, smoke: bool) -> dict:
    doc = {
        "bench": "federation",
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
    routers = list_routers()
    print(f"# federation: {num_jobs} jobs/stream, FCFS+pack, 60s lockstep "
          f"windows, routers={','.join(routers)}")
    print(f"{'scenario':20s} {'router':16s} {'waitP99h':>8s} {'jctP99h':>8s} "
          f"{'util':>5s} {'fair':>5s} {'routed':>22s} {'wall(s)':>8s}")
    results: dict[str, dict] = {}
    for scenario in SCENARIOS:
        for router in routers:
            r = stream_once(scenario, router, num_jobs)
            assert r["completed"] == num_jobs, \
                (scenario, router, r["completed"])
            results[f"{scenario}/{router}"] = r
            print(f"{scenario:20s} {router:16s} {r['wait_p99_h']:8.2f} "
                  f"{r['jct_p99_h']:8.2f} {r['utilization']:5.2f} "
                  f"{r['fairness']:5.2f} {str(r['routed']):>22s} "
                  f"{r['wall_s']:8.1f}")
            if out is not None:
                out.append(f"federation/{scenario}/{router}/wait_p99_h,"
                           f"{r['wait_p99_h']:.4f},"
                           f"util {r['utilization']:.2f}")
    doc = _emit_json(results, num_jobs, smoke)
    print(f"# wrote {os.path.normpath(JSON_PATH)}")
    acc = doc["acceptance"]
    for name in ("jsq", "sku_affinity"):
        if f"{name}_beats_hash" in acc:
            verdict = "BEATS" if acc[f"{name}_beats_hash"] else "LOSES TO"
            print(f"# {name} {verdict} hash on {ACCEPTANCE_SCENARIO} "
                  f"wait-p99 ({acc[f'{name}_wait_p99_h']:.2f}h vs "
                  f"{acc['hash_wait_p99_h']:.2f}h)")
    return doc


if __name__ == "__main__":
    device_main(run, __doc__, smoke=SMOKE_JOBS)

"""Scale-curve benchmark on the port: deep queues, tiled 100k–1M-job traces,
10k-node fleets.

The analog of ``benchmarks/bench_scale_curve.py`` on ``repro_torch``.  Four
point families, all written to ``benchmarks_torch/BENCH_scale_curve.json``:

- **window curve** — flash-crowd stream at queue_window 1024/4096/16384:
  jobs/s plus mean/p99 decision latency (sub-linear p99 growth is a gate;
  ``speedup_vs_pre_pr`` divides by the reference's ``PRE_PR`` baseline,
  timed on its CI container, so it reads another host and gates nothing
  here beyond what the reference's document records);
- **trace curve** — the same stream tiled (re-id + time-shift) to 100k
  jobs (quick) or 1M (full), streamed in compact completed-summary mode
  so memory stays bounded; peak RSS is stamped per point;
- **fleet point** — a synthetic 10k-node federation (8 members x 1250
  nodes) stepped serially and with ``parallel=True`` (members in threads);
  the two runs must be bit-identical in job tuples and decision counters
  (the bench raises on divergence);
- **MILP cache point** — repeated-shape ``choose_allocation`` bursts with
  the solution cache on vs off.

FCFS + ``pack`` on the host: no tensor and no kernel.  Modes: quick
(default) / REPRO_BENCH_SCALE=full (1M-job trace point); ``smoke=True``
shrinks to <=1k jobs and qw<=2048.  REPRO_BENCH_SCALE_CURVE_JOBS overrides
the window curve's stream size, REPRO_BENCH_SCALE_CURVE_JSON the artifact
path; ``--device`` (or REPRO_BENCH_DEVICE) is recorded in the provenance.

    PYTHONPATH=src python -m benchmarks_torch.bench_scale_curve [--device cpu]
"""
from __future__ import annotations

import dataclasses
import math
import os
import platform
import time

import numpy as np

from benchmarks_torch.common import (DecisionTimer, device_main, drive_stream,
                                     peak_rss_mb, provenance, rounded,
                                     write_json)
from repro_torch.core import PolicyPrioritizer, make_policy
from repro_torch.core.cluster import ClusterState
from repro_torch.core.milp import choose_allocation
from repro_torch.core.types import ClusterSpec, Job, NodeSpec
from repro_torch.fed import run_fleet
from repro_torch.fed.scenarios import FleetRun
from repro_torch.sched import SchedulerEngine, get_scenario

SCALE = os.environ.get("REPRO_BENCH_SCALE", "quick")
#: base stream size for the window curve — the reference's pre-PR baseline
#: was measured at exactly this size
NUM_JOBS = int(os.environ.get("REPRO_BENCH_SCALE_CURVE_JOBS", 10_000))
TRACE_JOBS = {"quick": 100_000, "full": 1_000_000}[SCALE]
QUEUE_WINDOWS = (1024, 4096, 16384)
SMOKE_WINDOWS = (1024, 2048)
FLEET_MEMBERS = 8
FLEET_NODES_PER_MEMBER = 1250          # 8 x 1250 = 10k nodes
SMOKE_NODES_PER_MEMBER = 125
JSON_PATH = os.environ.get(
    "REPRO_BENCH_SCALE_CURVE_JSON",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "BENCH_scale_curve.json"))

#: the reference's pre-PR engine, timed on its CI container (flash-crowd
#: 10k jobs FCFS+pack): the denominators of its deep-queue speedup field
PRE_PR = {
    "qw1024": {"jobs_per_s": 1040.7, "lat_p99_ms": 0.0376},
    "qw4096": {"jobs_per_s": 496.1, "lat_p99_ms": 0.0948},
    "qw16384": {"jobs_per_s": 442.8, "lat_p99_ms": 0.1066},
}
#: the two deepest-queue points' jobs/s over PRE_PR, as the reference
#: records it
SPEEDUP_GATE = 2.0


def _stream(spec, fault_model, jobs: list[Job], queue_window: int, *,
            compact: bool = False, deep_lookahead_k: int | None = None) -> dict:
    """Stream ``jobs`` through a fresh engine (1h ingest chunks, the
    bench_streaming loop) and report throughput + decision latency."""
    pri = DecisionTimer(PolicyPrioritizer(make_policy("fcfs")))
    engine = SchedulerEngine(spec, pri, allocator="pack",
                             fault_model=fault_model,
                             queue_window=queue_window,
                             completed_summary=compact,
                             deep_lookahead_k=deep_lookahead_k)
    wall = drive_stream(engine, [j.clone_pending() for j in jobs])
    lat = np.array(pri.lat) if pri.lat else np.zeros(1)
    return {
        "completed": engine.completed_count,
        "wall_s": wall,
        "jobs_per_s": engine.completed_count / max(wall, 1e-9),
        "decisions": engine.decisions,
        "backfills": engine.backfills,
        "lat_mean_ms": 1e3 * float(lat.mean()),
        "lat_p99_ms": 1e3 * float(np.percentile(lat, 99)),
        "compact_mode": compact,
        "peak_rss_mb": peak_rss_mb(),
    }


def _tile_jobs(base: list[Job], tiles: int) -> list[Job]:
    """Tile a trace ``tiles`` times: each copy is re-identified and
    time-shifted past the previous tile's last arrival, so a 10k-job
    scenario becomes a continuous 100k/1M-job stream with the same local
    arrival structure."""
    lo = min(j.submit_time for j in base)
    hi = max(j.submit_time for j in base)
    span = (hi - lo) + 60.0
    stride = max(j.job_id for j in base) + 1
    out: list[Job] = []
    for t in range(tiles):
        for j in base:
            out.append(dataclasses.replace(
                j, job_id=j.job_id + t * stride,
                submit_time=j.submit_time + t * span))
    return out


def _fleet_run(nodes_per_member: int, num_jobs: int, seed: int) -> FleetRun:
    """Synthetic large fleet: FLEET_MEMBERS uniform members, mixed small/
    large jobs arriving over ~4 simulated hours."""
    rng = np.random.default_rng(seed)
    clusters = []
    for m in range(FLEET_MEMBERS):
        nodes = [NodeSpec(node_id=i, gpu_type="V100", num_gpus=8,
                          num_cpus=96, mem_gb=768.0)
                 for i in range(nodes_per_member)]
        clusters.append(ClusterSpec(nodes=nodes, name=f"pod{m}"))
    arrivals = np.sort(rng.uniform(0.0, 4 * 3600.0, size=num_jobs))
    sizes = rng.choice([1, 2, 4, 8], size=num_jobs,
                       p=[0.45, 0.25, 0.2, 0.1])
    runtimes = np.clip(rng.lognormal(7.0, 1.0, size=num_jobs), 120.0, 86400.0)
    jobs = [Job(job_id=i, user=int(rng.integers(0, 64)),
                submit_time=float(arrivals[i]), runtime=float(runtimes[i]),
                est_runtime=float(runtimes[i]), num_gpus=int(sizes[i]),
                gpu_type="V100", vc=int(rng.integers(0, 4)))
            for i in range(num_jobs)]
    return FleetRun(name=f"scale-fleet-{FLEET_MEMBERS}x{nodes_per_member}",
                    clusters=tuple(clusters), jobs=jobs,
                    fault_models=(None,) * FLEET_MEMBERS)


def _fleet_sig(sr) -> tuple:
    """Bit-identity signature: completed job tuples + per-member decision
    counters + routing counts."""
    jobs = tuple(sorted((j.job_id, j.submit_time, j.first_start_time,
                         j.finish_time, j.num_gpus)
                        for j in sr.result.jobs))
    eng = sr.fed.engines
    return (jobs, tuple(e.decisions for e in eng),
            tuple(e.backfills for e in eng), tuple(sr.fed.routed))


def _fleet_point(nodes_per_member: int, num_jobs: int) -> dict:
    run = _fleet_run(nodes_per_member, num_jobs, seed=0)
    walls = {}
    sigs = {}
    for mode, par in (("serial", False), ("parallel", True)):
        t0 = time.perf_counter()
        sr = run_fleet(run, seed=0, router="jsq", allocator="pack",
                       rescan_interval=60.0, sample_interval=3600.0,
                       parallel=par)
        walls[mode] = time.perf_counter() - t0
        sigs[mode] = _fleet_sig(sr)
    identical = sigs["serial"] == sigs["parallel"]
    return {
        "members": FLEET_MEMBERS,
        "total_nodes": FLEET_MEMBERS * nodes_per_member,
        "total_gpus": FLEET_MEMBERS * nodes_per_member * 8,
        "num_jobs": num_jobs,
        "completed": len(sigs["serial"][0]),
        "wall_serial_s": walls["serial"],
        "wall_parallel_s": walls["parallel"],
        "parallel_speedup": walls["serial"] / max(walls["parallel"], 1e-9),
        "serial_parallel_identical": identical,
        "peak_rss_mb": peak_rss_mb(),
    }


def _milp_cache_point(calls: int) -> dict:
    """Repeated-shape allocation burst: the solution cache must turn the
    steady-state solve into a dict hit.  Multi-node gangs (12–32 GPUs on
    8-GPU nodes) make spread and pack genuinely distinct, so the binary
    way1-vs-way2 solve actually runs; ways/lookahead construction sits
    outside the timed region — only ``choose_allocation`` is measured."""
    spec = ClusterSpec(nodes=[NodeSpec(node_id=i, gpu_type="V100",
                                       num_gpus=8, num_cpus=96, mem_gb=768.0)
                              for i in range(16)])
    cluster = ClusterState(spec)
    # fragment half the nodes (4 of 8 GPUs busy) so spread and pack are
    # genuinely distinct placements and the binary solve actually runs
    for i in range(8):
        filler = Job(job_id=9_000 + i, user=0, submit_time=0.0,
                     runtime=86400.0, est_runtime=86400.0, num_gpus=4,
                     gpu_type="V100")
        cluster.allocate(filler, {i: 4})
    shapes = (8, 12, 16, 24)
    probes = []
    for k, g in enumerate(shapes):
        job = Job(job_id=k, user=0, submit_time=0.0, runtime=3600.0,
                  est_runtime=3600.0, num_gpus=g, gpu_type="V100")
        look = [Job(job_id=100 + k * 8 + i, user=0, submit_time=0.0,
                    runtime=1800.0, est_runtime=1800.0,
                    num_gpus=shapes[(k + i) % len(shapes)],
                    gpu_type="V100") for i in range(4)]
        probes.append((job, cluster.candidate_ways(job), look))
    walls = {}
    for mode, cached in (("uncached", False), ("cached", True)):
        if hasattr(cluster, "_milp_sol_cache"):
            del cluster._milp_sol_cache
        t0 = time.perf_counter()
        for k in range(calls):
            job, ways, look = probes[k % len(probes)]
            choose_allocation(cluster, job, ways, look,
                              solution_cache=cached)
        walls[mode] = time.perf_counter() - t0
    return {
        "calls": calls,
        "wall_uncached_s": walls["uncached"],
        "wall_cached_s": walls["cached"],
        "cache_speedup": walls["uncached"] / max(walls["cached"], 1e-9),
    }


def run(out: list[str] | None = None, smoke: bool = False) -> dict:
    num_jobs = 1_000 if smoke else NUM_JOBS
    windows = SMOKE_WINDOWS if smoke else QUEUE_WINDOWS
    trace_jobs = 1_000 if smoke else TRACE_JOBS
    nodes_per = SMOKE_NODES_PER_MEMBER if smoke else FLEET_NODES_PER_MEMBER
    fleet_jobs = 800 if smoke else num_jobs
    milp_calls = 200 if smoke else 2_000

    base = get_scenario("flash-crowd").build(num_jobs, seed=0)

    # ---- window curve -------------------------------------------------
    print(f"# scale curve: flash-crowd {num_jobs} jobs, FCFS+pack")
    print(f"{'point':18s} {'jobs/s':>8s} {'dec':>7s} {'lat.p99':>9s} "
          f"{'rss(MB)':>8s} {'wall(s)':>8s}")
    window_curve: dict[str, dict] = {}
    for qw in windows:
        r = _stream(base.spec, base.fault_model, base.jobs, qw)
        assert r["completed"] == num_jobs, (qw, r["completed"])
        window_curve[f"qw{qw}"] = r
        print(f"{'window/qw' + str(qw):18s} {r['jobs_per_s']:8.0f} "
              f"{r['decisions']:7d} {r['lat_p99_ms']:7.4f}ms "
              f"{r['peak_rss_mb'] or 0:8.0f} {r['wall_s']:8.1f}")
        if out is not None:
            out.append(f"scale_curve/qw{qw}/lat_p99_ms,"
                       f"{r['lat_p99_ms']:.4f},"
                       f"{r['jobs_per_s']:.0f} jobs/s")

    # ---- trace-size curve (tiled, compact completed mode) -------------
    tiles = max(1, math.ceil(trace_jobs / num_jobs))
    trace = _tile_jobs(base.jobs, tiles)[:trace_jobs] if tiles > 1 \
        else base.jobs
    r = _stream(base.spec, base.fault_model, trace, windows[0],
                compact=True, deep_lookahead_k=4)
    assert r["completed"] == len(trace), (len(trace), r["completed"])
    trace_curve = {f"jobs{len(trace)}": r}
    print(f"{'trace/' + str(len(trace)):18s} {r['jobs_per_s']:8.0f} "
          f"{r['decisions']:7d} {r['lat_p99_ms']:7.4f}ms "
          f"{r['peak_rss_mb'] or 0:8.0f} {r['wall_s']:8.1f}")
    if out is not None:
        out.append(f"scale_curve/trace{len(trace)}/jobs_per_s,"
                   f"{r['jobs_per_s']:.0f},"
                   f"rss {r['peak_rss_mb'] or 0:.0f}MB compact")

    # ---- fleet point (serial vs parallel, bit-identity gate) ----------
    fp = _fleet_point(nodes_per, fleet_jobs)
    print(f"{'fleet/' + str(fp['total_nodes']) + 'n':18s} "
          f"{fp['num_jobs'] / max(fp['wall_serial_s'], 1e-9):8.0f} "
          f"{'-':>7s} {'-':>9s} {fp['peak_rss_mb'] or 0:8.0f} "
          f"{fp['wall_serial_s']:8.1f}")
    print(f"# fleet parallel: x{fp['parallel_speedup']:.2f} vs serial, "
          f"identical={fp['serial_parallel_identical']}")
    if out is not None:
        out.append(f"scale_curve/fleet{fp['total_nodes']}n/wall_s,"
                   f"{fp['wall_serial_s']:.2f},"
                   f"parallel x{fp['parallel_speedup']:.2f} "
                   f"identical={fp['serial_parallel_identical']}")

    # ---- MILP solution-cache point ------------------------------------
    mp = _milp_cache_point(milp_calls)
    print(f"# milp cache: {mp['calls']} calls, "
          f"x{mp['cache_speedup']:.1f} cached vs uncached")

    # ---- gates ---------------------------------------------------------
    lo_key, hi_key = f"qw{windows[0]}", f"qw{windows[-1]}"
    lat_ratio = (window_curve[hi_key]["lat_p99_ms"]
                 / max(window_curve[lo_key]["lat_p99_ms"], 1e-9))
    window_ratio = windows[-1] / windows[0]
    gates: dict = {
        "p99_latency_growth": {
            "window_ratio": window_ratio,
            "latency_ratio": round(lat_ratio, 3),
            "sublinear": bool(lat_ratio < window_ratio),
        },
        "fleet_serial_parallel_identical": fp["serial_parallel_identical"],
    }
    speedups = {}
    if not smoke and num_jobs == 10_000:   # baseline recorded at this size
        for key, basev in PRE_PR.items():
            if key in window_curve:
                speedups[key] = round(
                    window_curve[key]["jobs_per_s"] / basev["jobs_per_s"], 2)
        deepest = [f"qw{w}" for w in windows[-2:]]
        gates["deep_queue_speedup"] = {
            "gate": SPEEDUP_GATE,
            "points": {k: speedups.get(k) for k in deepest},
            "passed": all((speedups.get(k) or 0) >= SPEEDUP_GATE
                          for k in deepest),
        }

    doc = {
        "bench": "scale_curve",
        "scale": "smoke" if smoke else SCALE,
        "num_jobs": num_jobs,
        "trace_jobs": len(trace),
        "policy": "fcfs",
        "allocator": "pack",
        "host": platform.node() or "unknown",
        "machine": platform.machine(),
        "baseline_host_note": "PRE_PR measured on the original CI container "
                              "at 10k jobs; compare speedup_vs_pre_pr only "
                              "on matching hardware",
        "window_curve": {k: rounded(r) for k, r in window_curve.items()},
        "trace_curve": {k: rounded(r) for k, r in trace_curve.items()},
        "fleet": rounded(fp),
        "milp_cache": rounded(mp),
        "pre_pr_baseline": PRE_PR,
        "speedup_vs_pre_pr": speedups,
        "gates": gates,
        "provenance": provenance(seed=0, host_only=True),
    }
    write_json(JSON_PATH, doc)
    print(f"# wrote {os.path.normpath(JSON_PATH)}")
    g = gates["p99_latency_growth"]
    print(f"# p99 growth {lo_key}->{hi_key}: latency x{g['latency_ratio']:.2f}"
          f" over window x{g['window_ratio']:.0f} "
          f"({'sub-linear' if g['sublinear'] else 'SUPER-linear'})")
    if speedups:
        pretty = ", ".join(f"{k} {v:.2f}x" for k, v in sorted(speedups.items()))
        print(f"# jobs/s vs pre-PR (another host's baseline): {pretty}")
    if not fp["serial_parallel_identical"]:
        raise AssertionError("parallel federation diverged from serial")
    return doc


if __name__ == "__main__":
    device_main(run, __doc__)

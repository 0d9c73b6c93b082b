"""Prediction benchmark on the port: predictor-assisted EASY backfill vs
blind backfill.

The analog of ``benchmarks/bench_prediction.py`` on ``repro_torch``: the
same four congested scenarios (``flash-crowd``, ``padded-estimates``,
``overcommit-queue``, ``mispredict-storm``), each streamed through
``run_scenario`` blind (declared-estimate backfill gating) and assisted (an
online ``RuntimePredictor`` whose p90 quantile gates backfill reservations,
feeds MILP lookahead durations and enforces overruns, its batched forward
the ``predict_mlp`` kernel on the card), compared on completed-job
wait-p99.

Acceptance (recorded in ``benchmarks_torch/BENCH_prediction.json``), the
reference's gates with their bounds (they read schedules, not the host):

- assisted beats blind on wait-p99 on >= ``MIN_WINS`` of the scenarios;
- the MLP's prequential MAPE beats the per-(user, gpus-bucket)
  running-mean baseline, pooled over all assisted streams;
- on ``mispredict-storm`` assisted wait-p99 stays inside
  ``<= WAIT_BAND_FACTOR * blind + WAIT_BAND_SLACK_S``.

Modes: REPRO_BENCH_SCALE=full streams 10k jobs, default (quick) 3k;
``--smoke`` caps at <= 600.  REPRO_BENCH_PREDICT_JOBS overrides the job
count, REPRO_BENCH_PREDICT_JSON the artifact path.  ``--device cpu`` (or
REPRO_BENCH_DEVICE) runs the predictor on the CPU.

    PYTHONPATH=src python -m benchmarks_torch.bench_prediction [--smoke] [--device cpu]
"""
from __future__ import annotations

import json
import os
import platform
import sys
import time

import numpy as np

from benchmarks_torch.common import DEVICE_ENV, bench_device, provenance
from repro_torch.core.policies import make_policy
from repro_torch.core.prioritizer import PolicyPrioritizer
from repro_torch.predict import RuntimePredictor
from repro_torch.sched import get_scenario, run_scenario

SCALE = os.environ.get("REPRO_BENCH_SCALE", "quick")
NUM_JOBS = int(os.environ.get("REPRO_BENCH_PREDICT_JOBS",
                              {"quick": 3_000, "full": 10_000}[SCALE]))
SMOKE_JOBS = 600
SCENARIOS = ("flash-crowd", "padded-estimates", "overcommit-queue",
             "mispredict-storm")
STORM = "mispredict-storm"
#: assisted must beat blind wait-p99 on at least this many scenarios
MIN_WINS = 2
#: wait-p99 band assisted must stay inside when mispredictions storm
WAIT_BAND_FACTOR = 1.5
WAIT_BAND_SLACK_S = 1800.0
JSON_PATH = os.environ.get(
    "REPRO_BENCH_PREDICT_JSON",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "BENCH_prediction.json"))


def _prioritizer() -> PolicyPrioritizer:
    # use_estimates=True: blind backfill gates on the declared (noisy)
    # estimate, never the oracle runtime — the deployable baseline
    return PolicyPrioritizer(make_policy("fcfs", use_estimates=True))


def stream_once(scenario: str, num_jobs: int,
                assisted: bool) -> tuple[dict, RuntimePredictor | None]:
    run = get_scenario(scenario).build(num_jobs, 0)
    pred = RuntimePredictor(assist=True, seed=0, device=bench_device()) \
        if assisted else None
    t0 = time.perf_counter()
    sr = run_scenario(run, allocator="pack", rescan_interval=60.0,
                      sample_interval=3600.0, prioritizer=_prioritizer(),
                      predictor=pred)
    wall = time.perf_counter() - t0
    jobs = sr.batch.jobs
    waits = np.array([j.wait_time for j in jobs]) if jobs else np.zeros(1)
    eng = sr.engine
    row = {
        "completed": len(jobs),
        "wall_s": wall,
        "jobs_per_s": len(jobs) / max(wall, 1e-9),
        "windows": sr.windows,
        "wait_p50_h": float(np.percentile(waits, 50)) / 3600.0,
        "wait_p99_h": float(np.percentile(waits, 99)) / 3600.0,
        "avg_wait_h": float(waits.mean()) / 3600.0,
        "utilization": sr.batch.utilization,
        "backfills": eng.backfills,
        "bf_reservations": eng.bf_reservations,
        "bf_overruns": eng.bf_overruns,
    }
    if pred is not None:
        row["train_steps"] = pred.train_steps
        row["mape_mlp"] = pred.mape()
        row["mape_baseline"] = pred.baseline_mape()
    return row, pred


def _acceptance(results: dict[str, dict],
                preds: dict[str, RuntimePredictor]) -> dict:
    out: dict = {
        "min_wins": MIN_WINS,
        "wait_band": f"<= {WAIT_BAND_FACTOR} * blind wait-p99 "
                     f"+ {WAIT_BAND_SLACK_S:.0f}s",
    }
    wins = 0
    for scen in SCENARIOS:
        blind = results.get(f"{scen}/blind")
        asst = results.get(f"{scen}/assisted")
        if blind is None or asst is None:
            continue
        key = scen.replace("-", "_")
        won = bool(asst["wait_p99_h"] < blind["wait_p99_h"])
        wins += won
        out[f"{key}_blind_wait_p99_h"] = round(blind["wait_p99_h"], 4)
        out[f"{key}_assisted_wait_p99_h"] = round(asst["wait_p99_h"], 4)
        out[f"{key}_assisted_wins"] = won
    out["wins"] = wins
    out["assisted_beats_blind"] = bool(wins >= MIN_WINS)
    # pooled prequential MAPE across every assisted stream, step-weighted
    n = sum(p.train_steps for p in preds.values())
    mlp = sum(p.mape() * p.train_steps for p in preds.values()) / max(n, 1)
    base = sum(p.baseline_mape() * p.train_steps
               for p in preds.values()) / max(n, 1)
    out["mape_mlp"] = round(mlp, 4)
    out["mape_baseline"] = round(base, 4)
    out["mlp_beats_baseline"] = bool(mlp < base)
    blind = results.get(f"{STORM}/blind")
    asst = results.get(f"{STORM}/assisted")
    if blind is not None and asst is not None:
        band_h = (WAIT_BAND_FACTOR * blind["wait_p99_h"]
                  + WAIT_BAND_SLACK_S / 3600.0)
        out["storm_wait_band_h"] = round(band_h, 4)
        out["storm_within_band"] = bool(asst["wait_p99_h"] <= band_h)
    return out


def _emit_json(results: dict[str, dict],
               preds: dict[str, RuntimePredictor],
               num_jobs: int, smoke: bool) -> dict:
    doc = {
        "bench": "prediction",
        "scale": "smoke" if smoke else SCALE,
        "num_jobs": num_jobs,
        "policy": "fcfs",
        "allocator": "pack",
        "rescan_interval_s": 60.0,
        "host": platform.node() or "unknown",
        "machine": platform.machine(),
        "results": {k: {m: (round(v, 4) if isinstance(v, float) else v)
                        for m, v in r.items()} for k, r in results.items()},
        "acceptance": _acceptance(results, preds),
        "provenance": provenance(seed=0),
    }
    with open(JSON_PATH, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return doc


def run(out: list[str] | None = None, smoke: bool = False) -> dict:
    num_jobs = min(NUM_JOBS, SMOKE_JOBS) if smoke else NUM_JOBS
    print(f"# prediction: {num_jobs} jobs/stream, FCFS(est)+pack, 60s "
          f"rescan, blind vs assisted backfill")
    print(f"{'scenario':18s} {'arm':9s} {'waitP99h':>8s} {'backfills':>9s} "
          f"{'overruns':>8s} {'MAPE':>6s} {'wall(s)':>8s}")
    results: dict[str, dict] = {}
    preds: dict[str, RuntimePredictor] = {}
    for scenario in SCENARIOS:
        for arm in ("blind", "assisted"):
            r, pred = stream_once(scenario, num_jobs, arm == "assisted")
            assert r["completed"] == num_jobs, (scenario, arm, r["completed"])
            results[f"{scenario}/{arm}"] = r
            if pred is not None:
                preds[scenario] = pred
            mape = f"{r['mape_mlp']:6.2f}" if "mape_mlp" in r else " " * 6
            print(f"{scenario:18s} {arm:9s} {r['wait_p99_h']:8.2f} "
                  f"{r['backfills']:9d} {r['bf_overruns']:8d} {mape} "
                  f"{r['wall_s']:8.1f}")
            if out is not None:
                out.append(f"prediction/{scenario}/{arm}/wait_p99_h,"
                           f"{r['wait_p99_h']:.4f},"
                           f"overruns {r['bf_overruns']}")
    doc = _emit_json(results, preds, num_jobs, smoke)
    print(f"# wrote {os.path.normpath(JSON_PATH)}")
    acc = doc["acceptance"]
    beat = "BEATS" if acc["assisted_beats_blind"] else "DOES NOT BEAT"
    print(f"# assisted {beat} blind on wait-p99 "
          f"({acc['wins']}/{len(SCENARIOS)} scenarios, need {MIN_WINS})")
    ml = "BEATS" if acc["mlp_beats_baseline"] else "DOES NOT BEAT"
    print(f"# MLP MAPE {acc['mape_mlp']:.2f} {ml} running-mean baseline "
          f"{acc['mape_baseline']:.2f}")
    if "storm_within_band" in acc:
        band = "WITHIN" if acc["storm_within_band"] else "OUTSIDE"
        key = STORM.replace("-", "_")
        print(f"# {STORM} assisted wait-p99 {band} band "
              f"({acc[f'{key}_assisted_wait_p99_h']:.2f}h vs "
              f"{acc['storm_wait_band_h']:.2f}h)")
    return doc


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m benchmarks_torch.bench_prediction",
        description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help=f"at most {SMOKE_JOBS} jobs a stream")
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    help="device of the predictor (default "
                         f"{DEVICE_ENV} or cuda)")
    args = ap.parse_args(argv)
    if args.device:
        os.environ[DEVICE_ENV] = args.device
    run(smoke=args.smoke)


if __name__ == "__main__":
    main(sys.argv[1:])

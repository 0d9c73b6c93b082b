"""Streaming-RL benchmark on the port: streaming-trained vs batch-trained
vs FCFS.

The analog of ``benchmarks/bench_rl_streaming.py`` on ``repro_torch``:
two PPO agents on the bench device, one trained on streaming episodes cut
from live ``SchedulerEngine`` runs (``StreamingTrainer``: dense shaped
rewards, GAE, warm congested clusters), one on idle-cluster batch pairs
(``RLTuneTrainer``: sparse terminal reward), both evaluated greedily
through ``service.run_stream`` against FCFS on identical builds of three
congested scenarios (flash-crowd, diurnal, sku-skew).  Every decision of
every rollout and evaluation runs the ``policy_mlp`` kernel on the card.

The ``acceptance`` block records whether the streaming-trained agent beats
FCFS on mean wait or mean JCT per scenario (the reference's gate: >= 2 of
3) in ``benchmarks_torch/BENCH_rl_streaming.json``.

Modes: quick (default) / REPRO_BENCH_SCALE=full scale the training budget;
``--smoke`` (or ``run(smoke=True)``) shrinks everything.  REPRO_BENCH_RL_JSON
overrides the artifact path, REPRO_BENCH_RL_STREAMS the training budget;
``--device cpu`` (or REPRO_BENCH_DEVICE) puts the agents on the CPU.

    PYTHONPATH=src python -m benchmarks_torch.bench_rl_streaming [--smoke] [--device cpu]
"""
from __future__ import annotations

import os
import platform
import sys
import time

from benchmarks_torch.common import (DEVICE_ENV, bench_device, provenance,
                                     write_json)
from repro_torch.core.agent import PPOConfig
from repro_torch.rl import (RLTuneTrainer, StreamingConfig, StreamingTrainer,
                            TrainerConfig)

SCALE = os.environ.get("REPRO_BENCH_SCALE", "quick")
SCENARIOS = ("flash-crowd", "diurnal", "sku-skew")
EVAL_JOBS = {"quick": 256, "full": 512}[SCALE]
STREAMS = int(os.environ.get("REPRO_BENCH_RL_STREAMS",
                             {"quick": 24, "full": 64}[SCALE]))
BATCHES = {"quick": 16, "full": 48}[SCALE]
JSON_PATH = os.environ.get(
    "REPRO_BENCH_RL_JSON",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "BENCH_rl_streaming.json"))


def _streaming_cfg(smoke: bool) -> StreamingConfig:
    if smoke:
        return StreamingConfig(scenarios=SCENARIOS, num_jobs=64, streams=2,
                               horizon=6, warmup_windows=2,
                               rescan_interval=300.0, seed=0)
    return StreamingConfig(
        scenarios=SCENARIOS, num_jobs=192, streams=STREAMS, horizon=12,
        warmup_windows=4, rescan_interval=300.0, seed=0,
        ppo=PPOConfig(episodes_per_update=2))


def _batch_cfg(smoke: bool) -> TrainerConfig:
    if smoke:
        return TrainerConfig(trace="helios", batch_size=32,
                             batches_per_epoch=2, epochs=1, variant="pro")
    return TrainerConfig(trace="helios", batch_size=96,
                         batches_per_epoch=BATCHES, epochs=1, variant="pro")


def _acceptance(results: dict[str, dict]) -> dict:
    """streaming vs FCFS per scenario on mean wait / mean JCT."""
    wins = 0
    out: dict = {"criterion": "streaming beats fcfs on mean wait or "
                              "mean JCT on >= 2 scenarios"}
    for name, row in results.items():
        s, f = row["streaming"], row["fcfs"]
        wait_beat = s["mean_wait"] < f["mean_wait"]
        jct_beat = s["mean_jct"] < f["mean_jct"]
        out[name] = {
            "streaming_wait_h": round(s["mean_wait"] / 3600.0, 4),
            "fcfs_wait_h": round(f["mean_wait"] / 3600.0, 4),
            "streaming_jct_h": round(s["mean_jct"] / 3600.0, 4),
            "fcfs_jct_h": round(f["mean_jct"] / 3600.0, 4),
            "beats_fcfs": bool(wait_beat or jct_beat),
        }
        wins += int(wait_beat or jct_beat)
    out["scenarios_beaten"] = wins
    out["passed"] = bool(wins >= 2)
    return out


def run(out: list[str] | None = None, smoke: bool = False) -> dict:
    eval_jobs = 96 if smoke else EVAL_JOBS
    scfg = _streaming_cfg(smoke)
    bcfg = _batch_cfg(smoke)

    t0 = time.perf_counter()
    streaming = StreamingTrainer(scfg, device=bench_device())
    eps = streaming.train()
    t_stream = time.perf_counter() - t0
    print(f"# streaming: {scfg.streams} streams x {scfg.num_jobs} jobs -> "
          f"{len(eps)} episodes, "
          f"{sum(e.steps for e in eps)} decisions in {t_stream:.0f}s")

    t0 = time.perf_counter()
    batch = RLTuneTrainer(bcfg, device=bench_device())
    batch.train()
    t_batch = time.perf_counter() - t0
    print(f"# batch: {bcfg.batches_per_epoch} x {bcfg.batch_size}-job pairs "
          f"({bcfg.variant}) in {t_batch:.0f}s")

    # identical scenario builds for every contender: evaluate the batch
    # agent through the same streaming harness
    batch_eval = StreamingTrainer(scfg, agent=batch.agent)

    results: dict[str, dict] = {}
    print(f"{'scenario':14s} {'contender':11s} {'waitH':>8s} {'jctH':>8s} "
          f"{'bsld':>7s} {'util':>5s}")
    for name in SCENARIOS:
        ev_s = streaming.evaluate((name,), num_jobs=eval_jobs, seed=1234)
        ev_b = batch_eval.evaluate((name,), num_jobs=eval_jobs, seed=1234,
                                   baselines=())
        row = {"streaming": ev_s[name]["rl"], "fcfs": ev_s[name]["fcfs"],
               "batch": ev_b[name]["rl"]}
        results[name] = row
        for contender in ("streaming", "batch", "fcfs"):
            m = row[contender]
            print(f"{name:14s} {contender:11s} {m['mean_wait']/3600:8.3f} "
                  f"{m['mean_jct']/3600:8.3f} {m['bsld']:7.2f} "
                  f"{m['utilization']:5.2f}")
            if out is not None:
                out.append(f"rl_streaming/{name}/{contender}/wait_h,"
                           f"{m['mean_wait']/3600:.4f},"
                           f"jct_h {m['mean_jct']/3600:.4f}")

    acc = _acceptance(results)
    doc = {
        "bench": "rl_streaming",
        "scale": "smoke" if smoke else SCALE,
        "eval_jobs": eval_jobs,
        "train": {"streams": scfg.streams, "jobs_per_stream": scfg.num_jobs,
                  "horizon": scfg.horizon, "episodes": len(eps),
                  "streaming_train_s": round(t_stream, 1),
                  "batch_pairs": bcfg.batches_per_epoch,
                  "batch_train_s": round(t_batch, 1)},
        "host": platform.node() or "unknown",
        "machine": platform.machine(),
        "results": {k: {c: {m: round(v, 4) for m, v in cm.items()}
                        for c, cm in r.items()} for k, r in results.items()},
        "acceptance": acc,
        "provenance": provenance(seed=0),
    }
    write_json(JSON_PATH, doc)
    print(f"# wrote {os.path.normpath(JSON_PATH)}")
    print(f"# streaming beats fcfs on {acc['scenarios_beaten']}/"
          f"{len(SCENARIOS)} scenarios -> "
          f"{'PASS' if acc['passed'] else 'FAIL'} (criterion: >= 2)")
    return doc


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m benchmarks_torch.bench_rl_streaming",
        description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the smallest training and evaluation")
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    help="device of the agents (default "
                         f"{DEVICE_ENV} or cuda)")
    args = ap.parse_args(argv)
    if args.device:
        os.environ[DEVICE_ENV] = args.device
    run(smoke=args.smoke)


if __name__ == "__main__":
    main(sys.argv[1:])

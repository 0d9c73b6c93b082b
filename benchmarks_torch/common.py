"""Shared helpers of the port's benches: agent training and caching,
evaluation, CSV rows, the provenance stamp of every
``benchmarks_torch/BENCH_*.json`` record, and the stream loop and
decision timer of the host benches (streaming, scale curve, obs).

The analog of ``benchmarks/common.py`` on ``repro_torch``: the same scale
knobs (the same ``REPRO_BENCH_*`` variables), the same cache layout and
checkpoint format (each package reads the other's agents), the same rows.
Agents live on the device named by ``REPRO_BENCH_DEVICE`` (``cuda`` unless
``benchmarks_torch.run --device cpu`` or the variable says otherwise).
"""
from __future__ import annotations

import datetime
import json
import os
import platform
import subprocess
import sys
import time

from repro_torch.core import improvement
from repro_torch.core.trainer import RLTuneTrainer, TrainerConfig

ART = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts")
#: the agent cache, read at call time (a test may point it elsewhere)
AGENTS = os.path.join(ART, "agents")

# benchmark scale knobs; REPRO_BENCH_SCALE=full for paper-scale runs (100
# batches/epoch, batch 256)
SCALE = os.environ.get("REPRO_BENCH_SCALE", "quick")
TRAIN_BATCHES = int(os.environ.get("REPRO_BENCH_TRAIN_BATCHES",
                                   {"quick": 60, "full": 100}[SCALE]))
BATCH_SIZE = {"quick": 128, "full": 256}[SCALE]
EVAL_BATCHES = int(os.environ.get("REPRO_BENCH_EVAL_BATCHES",
                                  {"quick": 4, "full": 10}[SCALE]))

#: set by ``benchmarks_torch.run --device``: where every bench puts its
#: agents and predictors
DEVICE_ENV = "REPRO_BENCH_DEVICE"

#: set by ``benchmarks_torch.run --rss`` (or exported directly): benches
#: that consult ``rss_enabled()`` stamp ``peak_rss_mb`` into every point
RSS_ENV = "REPRO_BENCH_RSS"


def bench_device() -> str:
    return os.environ.get(DEVICE_ENV, "cuda")


def rss_enabled() -> bool:
    return os.environ.get(RSS_ENV, "") not in ("", "0")


def peak_rss_mb() -> float | None:
    """Peak resident set size of this process in MB (None where the
    ``resource`` module is unavailable).  Linux reports ``ru_maxrss`` in KB,
    macOS in bytes."""
    try:
        import resource
    except ImportError:
        return None
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    if sys.platform == "darwin":
        peak /= 1024.0
    return round(peak / 1024.0, 1)


def cpu_model() -> str:
    """The host CPU's model name (``lscpu``'s "Model name"), or
    ``platform.processor()`` where ``/proc/cpuinfo`` is absent: the host
    benches' times read the host, not the card."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def _git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except OSError:
        pass
    return "unknown"


def provenance(seed: int | None = None, host_only: bool = False,
               device: str | None = None) -> dict:
    """Provenance stamp for ``benchmarks_torch/BENCH_*.json``: the code,
    the toolchain (torch, CUDA), the card (its name and power limit as
    ``nvidia-smi`` gives them; ``None`` when the benches run on the CPU),
    the host CPU, the knobs and the time.  A ``host_only`` bench puts no
    tensor on any device: its device is ``"host"`` and it names no card,
    whatever ``--device`` says; ``device`` overrides ``bench_device()``."""
    import numpy
    import torch

    from benchmarks_torch.bench_latency import nvidia_smi_line
    device = "host" if host_only else device or bench_device()
    on_card = device.startswith("cuda")
    stamp = {
        "git_sha": _git_sha(),
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": numpy.__version__,
        "device": device,
        "card": torch.cuda.get_device_name(0) if on_card else None,
        "nvidia_smi": nvidia_smi_line() if on_card else None,
        "host": platform.node() or "unknown",
        "machine": platform.machine(),
        "cpu": cpu_model(),
        "cpus": os.cpu_count(),
        "wall_clock_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "scale": SCALE,
    }
    if seed is not None:
        stamp["seed"] = seed
    return stamp


def agent_path(trace: str, policy: str, metric: str, variant: str) -> str:
    return os.path.join(AGENTS, f"{trace}__{policy}__{metric}__{variant}")


def get_trainer(trace: str, policy: str, metric: str = "wait",
                variant: str = "pro", train: bool = True, seed: int = 0,
                device: str | None = None) -> RLTuneTrainer:
    """Train (or load the cached) RLTune agent for (trace, base policy,
    metric, variant), on ``device`` (default: ``bench_device()``).  The
    cache is the reference's: one checkpoint at step 1 of the agent's
    ``state_dict()`` under ``agent_path``."""
    import torch

    from repro_torch.ckpt import latest_step, load_checkpoint, save_checkpoint
    from repro_torch.train.optimizer import map_tree
    cfg = TrainerConfig(trace=trace, base_policy=policy, metric=metric,
                        variant=variant, batch_size=BATCH_SIZE,
                        batches_per_epoch=TRAIN_BATCHES, epochs=1, seed=seed)
    tr = RLTuneTrainer(cfg, device=device or bench_device())
    path = agent_path(trace, policy, metric, variant)
    if train:
        if latest_step(path) is not None:
            target = map_tree(torch.from_numpy, tr.agent.state_dict())
            state, _ = load_checkpoint(path, target, device="cpu")
            tr.agent.load_state_dict(map_tree(torch.Tensor.numpy, state))
        else:
            t0 = time.time()
            tr.train()
            save_checkpoint(path, 1, map_tree(torch.from_numpy,
                                              tr.agent.state_dict()))
            print(f"#   trained {trace}/{policy}/{metric}/{variant} "
                  f"in {time.time() - t0:.0f}s")
    return tr


def eval_pair(tr: RLTuneTrainer, num_batches: int = 0) -> dict:
    ev = tr.evaluate(num_batches=num_batches or EVAL_BATCHES,
                     batch_size=BATCH_SIZE)
    out = {}
    for m in ("wait", "jct", "bsld", "util"):
        out[m] = (ev["base"][m], ev["rl"][m],
                  improvement(ev["base"][m], ev["rl"][m],
                              lower_is_better=(m != "util")))
    return out


def row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"


class DecisionTimer:
    """Wraps a prioritizer to record the wall-clock latency of each rank
    (both the plain protocol entry point and the engine's contiguous-field
    one).  ``rank_window`` is a method, so an engine built on the wrapper
    picks it up once (``getattr``) and takes the window route, as on the
    bare prioritizer."""

    def __init__(self, base):
        self.base = base
        self.use_estimates = base.use_estimates
        self.lat: list[float] = []

    def rank(self, jobs, cluster, now):
        t0 = time.perf_counter()
        out = self.base.rank(jobs, cluster, now)
        self.lat.append(time.perf_counter() - t0)
        return out

    def rank_window(self, jobs, cluster, now, fields):
        base = getattr(self.base, "rank_window", None)
        if base is None:
            return self.rank(jobs, cluster, now)
        t0 = time.perf_counter()
        out = base(jobs, cluster, now, fields)
        self.lat.append(time.perf_counter() - t0)
        return out

    def observe_finish(self, job):
        self.base.observe_finish(job)


def drive_stream(engine, jobs) -> float:
    """Stream ``jobs`` (sorted by submit time) through ``engine`` in
    1h-of-simulated-time chunks, stepping as each chunk lands; the horizon
    is anchored on the next due arrival or event, so traffic gaps are
    skipped and no event runs ahead of an unfed arrival.  Returns the wall
    seconds."""
    t0 = time.perf_counter()
    feed = 0
    while True:
        nxt = engine.next_event_time()
        if feed < len(jobs):
            nxt = min(nxt, jobs[feed].submit_time)
        if nxt == float("inf"):
            break
        horizon = max(engine.now, nxt) + 3600.0
        hi = feed
        while hi < len(jobs) and jobs[hi].submit_time <= horizon:
            hi += 1
        if hi > feed:
            engine.submit(jobs[feed:hi])
            feed = hi
        engine.step(horizon)
    return time.perf_counter() - t0


#: the fields of a bench record that read a clock, the host or an artifact
#: path (walls, jobs/s, latencies, speedups, peak RSS, the obs overhead and
#: the verdicts computed from latencies): two runs of one bench on the same
#: inputs, on any host and in either package, agree on every other field
CLOCK_FIELDS = frozenset({
    "provenance", "host", "machine", "trace_path", "prom_path",
    "wall_s", "wall_serial_s", "wall_parallel_s", "wall_uncached_s",
    "wall_cached_s", "jobs_per_s", "lat_mean_ms", "lat_p99_ms",
    "speedup_vs_pre_pr", "parallel_speedup", "cache_speedup", "peak_rss_mb",
    "latency_ratio", "sublinear", "p99_overhead", "p99_off_ms", "p99_on_ms",
    "mean_off_ms", "mean_on_ms", "within_bound", "passed",
    "deep_queue_speedup"})


def rounded(d: dict) -> dict:
    """``d`` with every float rounded to 4 places (the records' form)."""
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in d.items()}


def write_json(path: str, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def device_main(run, doc: str, smoke: int | None = None) -> None:
    """``python -m benchmarks_torch.bench_*`` for the host-only benches:
    ``--device`` (exported as ``REPRO_BENCH_DEVICE``, taken as every port
    bench takes it; these put no tensor on it and stamp ``"host"``) and,
    where the reference's CLI has it, ``--smoke`` (at most ``smoke`` jobs a
    stream); then ``run``."""
    import argparse
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    if smoke is not None:
        ap.add_argument("--smoke", action="store_true",
                        help=f"at most {smoke} jobs a stream")
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    help=f"bench device (default {DEVICE_ENV} or cuda); "
                    "this bench runs on the host only")
    args = ap.parse_args()
    if args.device:
        os.environ[DEVICE_ENV] = args.device
    if smoke is not None:
        run(smoke=args.smoke)
    else:
        run([])

"""Shared helpers of the port's paper benches: agent training and caching,
evaluation, CSV rows, and the provenance stamp of every
``benchmarks_torch/BENCH_*.json`` record.

The analog of ``benchmarks/common.py`` on ``repro_torch``: the same scale
knobs (the same ``REPRO_BENCH_*`` variables), the same cache layout and
checkpoint format (each package reads the other's agents), the same rows.
Agents live on the device named by ``REPRO_BENCH_DEVICE`` (``cuda`` unless
``benchmarks_torch.run --device cpu`` or the variable says otherwise).
"""
from __future__ import annotations

import datetime
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


def provenance(seed: int | None = None) -> dict:
    """Provenance stamp for ``benchmarks_torch/BENCH_*.json``: the code,
    the toolchain (torch, CUDA), the card (its name and power limit as
    ``nvidia-smi`` gives them; ``None`` when the benches run on the CPU),
    the knobs and the time."""
    import numpy
    import torch

    from benchmarks_torch.bench_latency import nvidia_smi_line
    device = bench_device()
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

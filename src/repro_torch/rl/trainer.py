"""Streaming PPO training on SchedulerEngine episodes.

``StreamingTrainer`` samples scenario streams from the registered scenario
distribution (``repro_torch.sched.scenarios``), replays each through the
rescan-interval service driver with a recording ``RLPrioritizer``, and lets
an ``EpisodeCutter`` slice the run into fixed-horizon episodes with dense
shaped rewards (see ``repro_torch.rl.episodes``).  The first ``warmup_windows``
windows of every stream run un-recorded, so episodes train on warm,
congested clusters — the non-stationary regime of the paper's Fig. 6 —
rather than the idle-cluster transient the legacy batch trainer sees.

Evaluation is greedy through ``service.run_stream`` against any base
policies on the same scenario builds (identical job copies / faults), so
streaming-trained, batch-trained, and heuristic schedulers are directly
comparable.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.agent import PPOAgent, PPOConfig
from repro_torch.core.env import RLPrioritizer
from repro_torch.core.policies import make_policy
from repro_torch.core.prioritizer import PolicyPrioritizer, Prioritizer
from repro_torch.rl.episodes import (EpisodeCutter, EpisodeStats,
                                     RewardWeights)
from repro_torch.sched.scenarios import ScenarioRun, get_scenario
from repro_torch.sched.service import run_stream


@dataclasses.dataclass
class StreamingConfig:
    """Streaming-trainer knobs.  ``scenarios`` is the episode distribution;
    each sampled stream is cut into ``ceil(windows / horizon)`` episodes."""

    scenarios: tuple[str, ...] = ("steady", "flash-crowd", "sku-skew")
    num_jobs: int = 160             # jobs per sampled stream
    streams: int = 8                # streams per train() call
    horizon: int = 12               # rescan windows per episode
    rescan_interval: float = 300.0
    warmup_windows: int = 4         # un-recorded windows per stream
    allocator: str = "pack"
    queue_window: int = 512
    use_estimates: bool = False
    reward: RewardWeights = dataclasses.field(default_factory=RewardWeights)
    seed: int = 0
    ppo: PPOConfig = dataclasses.field(default_factory=PPOConfig)


class StreamingTrainer:
    """Trains a PPO agent on streaming episodes; evaluates greedily.

    Pass an existing ``agent`` (e.g. one batch-trained by ``RLTuneTrainer``)
    to fine-tune or to evaluate it under the streaming harness; otherwise a
    new one is made on ``device`` (``"cuda"`` by default).
    """

    def __init__(self, cfg: StreamingConfig | None = None,
                 agent: PPOAgent | None = None, *,
                 device: torch.device | str | None = None):
        self.cfg = cfg or StreamingConfig()
        self.agent = agent or PPOAgent(self.cfg.ppo, device=device)
        self.history: list[EpisodeStats] = []

    # ----------------------------------------------------------------- train ----
    def train_stream(self, scenario: str | ScenarioRun,
                     seed: int = 0) -> list[EpisodeStats]:
        """Replay one scenario stream, cutting episodes as it runs."""
        cfg = self.cfg
        run = get_scenario(scenario).build(cfg.num_jobs, seed) \
            if isinstance(scenario, str) else scenario
        pri = RLPrioritizer(self.agent, explore=True,
                            use_estimates=cfg.use_estimates, streaming=True)
        cutter = EpisodeCutter(self.agent, pri, horizon=cfg.horizon,
                               weights=cfg.reward,
                               warmup_windows=cfg.warmup_windows,
                               scenario=run.name)
        run_stream(run.spec, [j.clone_pending() for j in run.jobs], pri,
                   rescan_interval=cfg.rescan_interval,
                   allocator=cfg.allocator, fault_model=run.fault_model,
                   queue_window=cfg.queue_window, chunked_submit=True,
                   hooks=(cutter,), on_window=cutter.on_window)
        cutter.flush()
        eps = list(cutter.episodes)
        self.history.extend(eps)
        return eps

    def train(self, streams: int | None = None,
              log_every: int = 0) -> list[EpisodeStats]:
        """Sample ``streams`` scenario streams from the distribution and
        train on every episode cut from them."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + 17)
        out: list[EpisodeStats] = []
        for si in range(streams if streams is not None else cfg.streams):
            name = cfg.scenarios[int(rng.integers(len(cfg.scenarios)))]
            eps = self.train_stream(name, seed=int(rng.integers(1_000_000)))
            out.extend(eps)
            if log_every and (si + 1) % log_every == 0:
                recent = [e.reward_sum for e in out[-8:]]
                print(f"[stream {si + 1}] {name}: {len(eps)} episodes, "
                      f"recent reward {np.mean(recent):+.3f}")
        return out

    # ------------------------------------------------------------------ eval ----
    def evaluate(self, scenarios: tuple[str, ...] | None = None,
                 num_jobs: int | None = None, seed: int = 1234,
                 baselines: tuple[str, ...] = ("fcfs",)) -> dict:
        """Greedy evaluation through ``service.run_stream``: the RL agent
        vs. ``baselines`` on identical scenario builds.  Returns
        ``{scenario: {"rl": metrics, <baseline>: metrics, ...}}``."""
        cfg = self.cfg
        out: dict[str, dict[str, dict[str, float]]] = {}
        for name in scenarios or cfg.scenarios:
            run = get_scenario(name).build(num_jobs or cfg.num_jobs, seed)
            row = {"rl": self._eval_once(
                run, RLPrioritizer(self.agent, explore=False,
                                   use_estimates=cfg.use_estimates,
                                   streaming=True))}
            for b in baselines:
                row[b] = self._eval_once(
                    run, PolicyPrioritizer(make_policy(b, cfg.use_estimates)))
            out[name] = row
        return out

    def _eval_once(self, run: ScenarioRun,
                   prioritizer: Prioritizer) -> dict[str, float]:
        cfg = self.cfg
        sr = run_stream(run.spec, [j.clone_pending() for j in run.jobs],
                        prioritizer, rescan_interval=cfg.rescan_interval,
                        allocator=cfg.allocator, fault_model=run.fault_model,
                        queue_window=cfg.queue_window, chunked_submit=True)
        b = sr.batch
        return {"mean_wait": b.avg_wait, "mean_jct": b.avg_jct,
                "bsld": b.avg_bsld, "utilization": b.utilization,
                "completed": float(len(b.jobs))}

"""Legacy batch-pair RLTune training & evaluation (paper Sec. 3.1).

The batch pipeline is the terminal-reward special case of the ``repro_torch.rl``
machinery: one "episode" = one 256-job batch drained to completion from an
idle cluster (``Simulator.run_batch``, itself a thin wrapper over the
streaming ``SchedulerEngine``), rewarded once with the normalized
base-vs-RL score gap through ``PPOAgent.finish_episode`` (the sparse
pathway).  ``repro_torch.core.trainer`` re-exports this module.  The agent
lives on one device (``device``, ``"cuda"`` by default): rollouts go through
the policy-MLP kernel there, and the PPO update runs there too, under
autograd over the plain actor and critic modules.

Training: each batch flows through two pipelines — the base policy pipeline
and the RL pipeline — on identical job copies and an identical idle
cluster.  One epoch = ``batches_per_epoch`` batches (paper: 100).

Evaluation: both pipelines run with user runtime estimates (noisy) and the
RL pipeline acts greedily.

For training on *streaming* episodes cut from a live engine (dense shaped
rewards, GAE), see ``repro_torch.rl.trainer.StreamingTrainer``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.agent import PPOAgent, PPOConfig
from repro_torch.core.env import InspectorPrioritizer, RLPrioritizer
from repro_torch.core.metrics import BatchResult, reward_from_scores
from repro_torch.core.policies import make_policy
from repro_torch.core.simulator import PolicyPrioritizer, Simulator
from repro_torch.core.trace import (PROFILES, generate_trace, make_cluster,
                                    train_eval_split)
from repro_torch.core.types import ClusterSpec, Job


@dataclasses.dataclass
class TrainerConfig:
    trace: str = "helios"
    base_policy: str = "fcfs"
    metric: str = "wait"            # wait | jct | bsld | util
    batch_size: int = 256
    batches_per_epoch: int = 100
    epochs: int = 1
    variant: str = "pro"            # pro | naive | inspector
    base_allocator: str = "pack"    # Slurm-like default for the base pipeline
    use_estimates_eval: bool = True
    lookahead_k: int = 8
    seed: int = 0
    ppo: PPOConfig = dataclasses.field(default_factory=PPOConfig)


@dataclasses.dataclass
class EpochStats:
    rewards: list[float]
    losses: list[float]
    abs_scores: list[float]
    ars_scores: list[float]

    @property
    def mean_reward(self) -> float:
        return float(np.mean(self.rewards)) if self.rewards else 0.0


class RLTuneTrainer:
    """Trains a PPO agent against a base policy on one trace."""

    def __init__(self, cfg: TrainerConfig, cluster: ClusterSpec | None = None,
                 jobs: list[Job] | None = None, *,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.cluster = cluster or make_cluster(cfg.trace)
        total = cfg.batch_size * cfg.batches_per_epoch * max(cfg.epochs, 1)
        total = int(total / 0.9) + cfg.batch_size   # leave the 10% eval split
        jobs = jobs or generate_trace(PROFILES[cfg.trace], total, seed=cfg.seed)
        self.train_jobs, self.eval_jobs = train_eval_split(jobs, 0.9)
        self.agent = PPOAgent(cfg.ppo, device=device)
        rl_alloc = "milp" if cfg.variant == "pro" else "pack"
        self.rl_sim = Simulator(self.cluster, allocator=rl_alloc,
                                lookahead_k=cfg.lookahead_k)
        self.base_sim = Simulator(self.cluster, allocator=cfg.base_allocator)

    # ----------------------------------------------------------------- train ----
    def _rl_prioritizer(self, explore: bool, use_estimates: bool):
        cfg = self.cfg
        if cfg.variant == "inspector":
            return InspectorPrioritizer(self.agent, make_policy(cfg.base_policy,
                                                                use_estimates),
                                        explore=explore, use_estimates=use_estimates)
        raw = cfg.variant == "naive"
        return RLPrioritizer(self.agent, explore=explore,
                             use_estimates=use_estimates, raw_features=raw)

    def _batches(self, jobs: list[Job], n: int, batch_size: int,
                 rng: np.random.Generator) -> list[list[Job]]:
        """n random contiguous windows of batch_size jobs (paper: random
        sequences of jobs per experiment run)."""
        out = []
        hi = max(len(jobs) - batch_size, 0)
        for _ in range(n):
            s = int(rng.integers(0, hi + 1))
            out.append(jobs[s:s + batch_size])
        return out

    def run_batch_pair(self, batch: list[Job], *, explore: bool,
                       use_estimates: bool) -> tuple[BatchResult, BatchResult]:
        """Run base and RL pipelines on identical copies of one batch."""
        cfg = self.cfg
        base_jobs = [j.clone_pending() for j in batch]
        rl_jobs = [j.clone_pending() for j in batch]
        base_pol = PolicyPrioritizer(make_policy(cfg.base_policy, use_estimates))
        base_res = self.base_sim.run_batch(base_jobs, base_pol)
        rl_res = self.rl_sim.run_batch(rl_jobs,
                                       self._rl_prioritizer(explore, use_estimates))
        return base_res, rl_res

    def train(self, epochs: int | None = None, batches_per_epoch: int | None = None,
              log_every: int = 0) -> list[EpochStats]:
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        bpe = batches_per_epoch or cfg.batches_per_epoch
        rng = np.random.default_rng(cfg.seed + 7)
        history: list[EpochStats] = []
        for ep in range(epochs):
            stats = EpochStats([], [], [], [])
            for bi, batch in enumerate(self._batches(self.train_jobs, bpe,
                                                     cfg.batch_size, rng)):
                self.agent.reset_buffer()
                base_res, rl_res = self.run_batch_pair(batch, explore=True,
                                                       use_estimates=False)
                abs_s = base_res.score(cfg.metric)
                ars_s = rl_res.score(cfg.metric)
                reward = reward_from_scores(abs_s, ars_s)
                upd = self.agent.finish_episode(reward)
                stats.rewards.append(reward)
                stats.losses.append(upd["loss"])
                stats.abs_scores.append(abs_s)
                stats.ars_scores.append(ars_s)
                if log_every and (bi + 1) % log_every == 0:
                    print(f"[epoch {ep} batch {bi + 1}/{bpe}] "
                          f"reward={np.mean(stats.rewards[-log_every:]):+.4f}")
            history.append(stats)
        return history

    # ------------------------------------------------------------------ eval ----
    def evaluate(self, num_batches: int = 10, batch_size: int | None = None,
                 seed: int = 1234) -> dict[str, dict[str, float]]:
        """Paper Sec. 5.2: random job sequences, RL greedy, noisy estimates."""
        cfg = self.cfg
        batch_size = batch_size or cfg.batch_size
        rng = np.random.default_rng(seed)
        pool = self.eval_jobs if len(self.eval_jobs) >= batch_size else self.train_jobs
        agg = {"base": {m: [] for m in ("wait", "jct", "bsld", "util")},
               "rl": {m: [] for m in ("wait", "jct", "bsld", "util")}}
        for batch in self._batches(pool, num_batches, batch_size, rng):
            base_res, rl_res = self.run_batch_pair(
                batch, explore=False, use_estimates=cfg.use_estimates_eval)
            for name, res in (("base", base_res), ("rl", rl_res)):
                agg[name]["wait"].append(res.avg_wait)
                agg[name]["jct"].append(res.avg_jct)
                agg[name]["bsld"].append(res.avg_bsld)
                agg[name]["util"].append(res.utilization)
        return {side: {m: float(np.mean(v)) for m, v in d.items()}
                for side, d in agg.items()}


def improvement(base: float, rl: float, lower_is_better: bool = True) -> float:
    """Percent improvement of RL over base."""
    if base == 0:
        return 0.0
    gain = (base - rl) / abs(base) if lower_is_better else (rl - base) / abs(base)
    return 100.0 * gain

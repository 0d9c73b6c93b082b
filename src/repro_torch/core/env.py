"""RL environment glue: prioritizers that drive the simulator.

RLPrioritizer implements the paper's RL pipeline: build state (FBM + feature
sampling), run the actor, return a ranking whose head is the sampled action
(exploration) or the greedy argmax (evaluation).

InspectorPrioritizer reimplements the *mechanism* of SchedInspector (Zhang et
al. '22) for the Table-9 comparison: a base heuristic proposes the ranking and
an RL gate decides execute-vs-skip for the head job.

NaiveRLPrioritizer (raw features, no sampling) + allocator="pack" reproduces
both naive-RLTune (Fig. 10) and the RLScheduler mechanism adapted to GPUs.

Streaming observe path (``streaming=True``): the prioritizer maintains
rolling EWMA statistics of the finished-job stream (``StreamStats``) fed by
the engine's ``observe_finish`` callback, and exposes ``record`` — a toggle
the episode cutter (``repro_torch.rl``) flips to warm a congested cluster under
the current policy without recording warm-up decisions into the PPO buffer.
Defaults (``streaming=False, record=True``) keep the legacy batch pipeline
bit-identical on fixed seeds.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import spans
from repro_torch.core.agent import PPOAgent
from repro_torch.core.cluster import ClusterState
from repro_torch.core.features import (CV_SIZE, MAX_QUEUE_SIZE, OV_SIZE,
                                 build_features, build_state,
                                 critic_features, pad_to_queue,
                                 sample_features)
from repro_torch.core.policies import Policy
from repro_torch.core.types import Job


@dataclasses.dataclass
class StreamStats:
    """Rolling EWMA view of the finished-job stream (streaming observe
    path).  The first finish seeds the averages; afterwards each finish
    moves them by ``alpha``."""

    alpha: float = 0.05
    finished: int = 0
    ewma_wait: float = 0.0
    ewma_jct: float = 0.0

    def update(self, job: Job) -> None:
        self.finished += 1
        a = 1.0 if self.finished == 1 else self.alpha
        self.ewma_wait += a * (job.wait_time - self.ewma_wait)
        self.ewma_jct += a * (job.jct - self.ewma_jct)


class RLPrioritizer:
    """The RLTune prioritizer (pro- or naive- variant)."""

    def __init__(self, agent: PPOAgent, *, explore: bool = True,
                 use_estimates: bool = False, raw_features: bool = False,
                 streaming: bool = False, deep_scorer=None):
        self.agent = agent
        self.explore = explore
        self.use_estimates = use_estimates
        self.raw_features = raw_features
        self.record = True
        self.stream_stats = StreamStats() if streaming else None
        #: opt-in deep-window tail scoring (a
        #: ``repro_torch.kernels.batch_score.BucketedScorer`` over the actor's
        #: own weights): queue rows beyond the MAX_QUEUE_SIZE actor window
        #: are ordered by the bucketed fused-MLP logits instead of FIFO.
        #: ``None`` (default) keeps the FIFO tail — bit-identical to the
        #: pre-scorer prioritizer, pinned by tests.
        self.deep_scorer = deep_scorer

    def set_mode(self, *, explore: bool | None = None,
                 record: bool | None = None) -> None:
        """Flip exploration/recording mid-stream (warm-up, greedy eval)."""
        if explore is not None:
            self.explore = explore
        if record is not None:
            self.record = record

    def rank(self, jobs: list[Job], cluster: ClusterState, now: float) -> list[int]:
        return self._rank(jobs, cluster, now, None)

    def rank_window(self, jobs: list[Job], cluster: ClusterState, now: float,
                    fields) -> list[int]:
        """``rank`` over the engine's contiguous ``WindowFields`` views: the
        FBM feature matrix is built with vectorized column ops instead of
        the O(window * 17) scalar loop — bit-identical features, hence
        bit-identical actions and ranking (differential-pinned)."""
        return self._rank(jobs, cluster, now, fields)

    def _rank(self, jobs, cluster, now, fields) -> list[int]:
        n = min(len(jobs), MAX_QUEUE_SIZE)
        tail_logits = None
        sp = spans.ACTIVE
        if sp is not None:
            sp.open("rltune.rank.features")
        if self.deep_scorer is not None and len(jobs) > MAX_QUEUE_SIZE:
            # one FBM pass over the whole window: the head state is built
            # from the exact rows build_state would produce (same feats ->
            # same act), and the tail rows are batch-scored through the
            # shape-bucketed fused-MLP kernel
            feats = build_features(jobs, cluster, now,
                                   use_estimates=self.use_estimates,
                                   fields=fields)
            if self.raw_features:
                ov_full = feats[:, :OV_SIZE]
            else:
                ov_full, _ = sample_features(feats, cluster)
            mask = np.zeros((MAX_QUEUE_SIZE,), dtype=np.float32)
            mask[:n] = 1.0
            ov = pad_to_queue(ov_full, OV_SIZE)
            cv = pad_to_queue(critic_features(feats), CV_SIZE)
            if sp is not None:
                sp.close()
                sp.open("rltune.rank.tail")
            tail_logits = self.deep_scorer.score(ov_full[n:])
        else:
            ov, cv, mask = build_state(jobs, cluster, now,
                                       use_estimates=self.use_estimates,
                                       raw=self.raw_features, fields=fields)
        if sp is not None:
            sp.close()
            sp.open("rltune.rank.actor")
        action, logits = self.agent.act(ov, cv, mask, explore=self.explore,
                                        record=self.explore and self.record)
        if sp is not None:
            sp.close()
        order = list(np.argsort(-logits[:n], kind="stable"))
        if action < n:
            order.remove(action)
            order.insert(0, action)
        if tail_logits is not None:
            # deep-window mode: tail ordered by the bucketed scorer
            # (stable argsort keeps FIFO among exact ties)
            order += [int(n + i)
                      for i in np.argsort(-tail_logits, kind="stable")]
        else:
            # jobs beyond the fixed-size window keep FIFO order at the tail
            order += list(range(n, len(jobs)))
        return order

    def observe_finish(self, job: Job) -> None:
        if self.stream_stats is not None:
            self.stream_stats.update(job)


class InspectorPrioritizer:
    """SchedInspector mechanism: base-policy ranking + RL execute/skip gate.

    The gate reuses the PPO agent with a 2-way action space encoded by
    restricting the mask to the first two queue slots: slot0 = execute the
    base decision, slot1 = skip this round (head job demoted once).
    """

    def __init__(self, agent: PPOAgent, base_policy: Policy, *,
                 explore: bool = True, use_estimates: bool = False):
        self.agent = agent
        self.base = base_policy
        self.explore = explore
        self.use_estimates = use_estimates

    def rank(self, jobs: list[Job], cluster: ClusterState, now: float) -> list[int]:
        scores = [self.base.score(j, now) for j in jobs]
        order = list(np.argsort(scores, kind="stable"))
        ov, cv, _ = build_state([jobs[i] for i in order], cluster, now,
                                use_estimates=self.use_estimates)
        gate_mask = np.zeros((MAX_QUEUE_SIZE,), dtype=np.float32)
        gate_mask[:min(2, len(jobs))] = 1.0
        action, _ = self.agent.act(ov, cv, gate_mask, explore=self.explore,
                                   record=self.explore)
        if action == 1 and len(order) > 1:   # skip: demote the head once
            order.append(order.pop(0))
        return order

    def observe_finish(self, job: Job) -> None:
        self.base.observe_finish(job)

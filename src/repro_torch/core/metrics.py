"""Scheduling performance metrics (Sec. 4.4): wait time, JCT, bounded
slowdown, GPU utilization — plus batch-level aggregation used for rewards."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import Job

METRICS = ("wait", "jct", "bsld", "util")


@dataclasses.dataclass
class BatchResult:
    """Outcome of scheduling one batch of jobs."""

    jobs: list[Job]
    makespan: float
    gpu_seconds_used: float
    gpu_seconds_capacity: float
    decisions: int = 0
    milp_calls: int = 0
    backfills: int = 0
    restarts: int = 0

    @property
    def avg_wait(self) -> float:
        return float(np.mean([j.wait_time for j in self.jobs])) if self.jobs else 0.0

    @property
    def total_wait(self) -> float:
        return float(np.sum([j.wait_time for j in self.jobs])) if self.jobs else 0.0

    @property
    def avg_jct(self) -> float:
        return float(np.mean([j.jct for j in self.jobs])) if self.jobs else 0.0

    @property
    def avg_bsld(self) -> float:
        return float(np.mean([j.bsld() for j in self.jobs])) if self.jobs else 0.0

    @property
    def utilization(self) -> float:
        return float(self.gpu_seconds_used / max(self.gpu_seconds_capacity, 1e-9))

    def score(self, metric: str) -> float:
        """Aggregated batch score — LOWER is better for all metrics
        (utilization is negated)."""
        if metric == "wait":
            return self.avg_wait
        if metric == "jct":
            return self.avg_jct
        if metric == "bsld":
            return self.avg_bsld
        if metric == "util":
            return -self.utilization
        raise ValueError(f"unknown metric {metric!r}")


def reward_from_scores(abs_score: float, ars_score: float) -> float:
    """Paper reward: normalized performance gap between the base pipeline
    (ABS) and the RL pipeline (ARS).  Positive when RL beats the baseline.
    Normalization reduces variance across bursty/easy batches (Sec. 3.2)."""
    denom = max(abs(abs_score), 1e-6)
    return float(np.clip((abs_score - ars_score) / denom, -10.0, 10.0))

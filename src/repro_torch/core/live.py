"""Live-deployment driver mimicking the paper's real Slurm integration
(Sec. 3.1.2 / 5.6): every `rescan_interval` seconds of cluster time the job
queue is rescanned, the RL agent re-prioritizes waiting + newly arrived jobs
(the `scontrol update priority=` path), and the MILP's spread-vs-pack verdict
toggles the OverSubscribe flag for the next placement.

SLA lane (Sec. 3.1.2): jobs flagged SLA-bound bypass RLTune and are ranked by
the baseline scheduler at the head of the queue, so RLTune's operational
overhead can never delay them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.agent import PPOAgent
from repro_torch.core.cluster import ClusterState
from repro_torch.core.features import MAX_QUEUE_SIZE, build_state
from repro_torch.core.policies import Policy, make_policy
from repro_torch.core.types import ClusterSpec, Job
from repro_torch.sched.service import run_stream


@dataclasses.dataclass
class LiveConfig:
    rescan_interval: float = 60.0        # paper: 1-minute scontrol loop
    sla_users: frozenset[int] = frozenset()
    base_policy: str = "slurm-mf"


class LivePrioritizer:
    """Prioritizer with cached priorities refreshed on a rescan interval,
    plus an SLA bypass lane ranked by the baseline scheduler."""

    def __init__(self, agent: PPOAgent, cfg: LiveConfig,
                 use_estimates: bool = True):
        self.agent = agent
        self.cfg = cfg
        self.use_estimates = use_estimates
        self.base: Policy = make_policy(cfg.base_policy, use_estimates)
        self._last_scan = -1e18
        self._prio: dict[int, float] = {}
        self.rescans = 0

    def _rescan(self, jobs: list[Job], cluster: ClusterState, now: float) -> None:
        ov, cv, mask = build_state(jobs, cluster, now,
                                   use_estimates=self.use_estimates)
        _, logits = self.agent.act(ov, cv, mask, explore=False, record=False)
        n = min(len(jobs), MAX_QUEUE_SIZE)
        for i in range(n):
            self._prio[jobs[i].job_id] = float(logits[i])
        for j in jobs[n:]:
            self._prio.setdefault(j.job_id, -1e6 - j.submit_time)
        self._last_scan = now
        self.rescans += 1

    def rank(self, jobs: list[Job], cluster: ClusterState, now: float) -> list[int]:
        if now - self._last_scan >= self.cfg.rescan_interval or \
                any(j.job_id not in self._prio for j in jobs):
            self._rescan(jobs, cluster, now)
        sla = [i for i, j in enumerate(jobs) if j.user in self.cfg.sla_users]
        rest = [i for i, j in enumerate(jobs) if j.user not in self.cfg.sla_users]
        sla.sort(key=lambda i: self.base.score(jobs[i], now))
        rest.sort(key=lambda i: -self._prio.get(jobs[i].job_id, -1e9))
        return sla + rest          # SLA lane always schedules first

    def observe_finish(self, job: Job) -> None:
        self.base.observe_finish(job)
        self._prio.pop(job.job_id, None)


def run_live(spec: ClusterSpec, jobs: list[Job], agent: PPOAgent,
             cfg: LiveConfig | None = None):
    """Simulated live deployment: returns (BatchResult, rescans).

    Routes through the streaming service driver (repro_torch.sched.service): the
    engine steps in `rescan_interval` windows exactly as the Slurm loop
    would poll it.  Window boundaries are unobservable to the schedule, so
    results match the former batch path bit-for-bit."""
    cfg = cfg or LiveConfig()
    pri = LivePrioritizer(agent, cfg)
    res = run_stream(spec, [j.clone_pending() for j in jobs], pri,
                     rescan_interval=cfg.rescan_interval, allocator="milp")
    return res.batch, pri.rescans

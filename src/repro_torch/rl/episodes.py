"""Episode cutting + dense reward shaping over the streaming engine.

The legacy trainer learns on idle-cluster 256-job batches with one sparse
terminal reward — a regime a production scheduler never sees.  Here,
``EpisodeCutter`` slices a *running* ``SchedulerEngine`` into fixed-horizon
PPO episodes: it observes the engine through the standard hook interface
(start/finish/requeue/tick feed an internal ``RollingTelemetry``; the
per-decision hook aligns policy steps), and at every rescan-window boundary
(the service driver's ``on_window`` callback) converts the **delta** of
rolling service metrics into a dense shaped reward:

    r_window = - w_wait    * Δ wait_p99  / wait_scale
               + w_util    * Δ utilization
               - w_backlog * Δ backlog   / backlog_scale      (clipped)

The window reward is split evenly over the decisions recorded in that
window (so a window's contribution is invariant to how many decisions it
took); windows with no decisions carry their reward into the next decision-
bearing window (folded into the episode's last step if the cut arrives
first).  After ``horizon`` windows the episode is closed and handed
to ``PPOAgent.finish_episode_dense`` — GAE(gamma, lambda) advantages, with
the critic's last value as the bootstrap for truncated episodes.
Consecutive episodes are cut from the same stream, so later episodes start
from a genuinely congested cluster.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.agent import PPOAgent
from repro_torch.sched.engine import EngineHooks, SchedulerEngine
from repro_torch.sched.telemetry import RollingTelemetry
from repro_torch.core.types import Job


@dataclasses.dataclass(frozen=True)
class RewardWeights:
    """Shaped-reward weights and scales (deltas between rescan windows)."""

    wait_p99: float = 1.0        # weight on rolling wait-p99 movement
    utilization: float = 0.5     # weight on windowed-utilization movement
    backlog: float = 1.0         # weight on pending-queue-depth movement
    wait_scale: float = 3600.0   # 1 h of wait-p99 movement ~ 1 reward unit
    backlog_scale: float = 64.0  # jobs of backlog movement ~ 1 reward unit
    clip: float = 5.0            # per-window reward clip


@dataclasses.dataclass(frozen=True)
class WindowStats:
    """Rolling-telemetry probe at one rescan-window boundary."""

    time: float
    wait_p99: float
    utilization: float
    backlog: int


_IDLE = WindowStats(time=0.0, wait_p99=0.0, utilization=0.0, backlog=0)


def shaped_reward(prev: WindowStats, cur: WindowStats,
                  w: RewardWeights) -> float:
    """Dense per-window reward from rolling-telemetry deltas.  Negative when
    the queue is deteriorating (wait-p99 / backlog growing), positive when
    the policy is draining it or lifting utilization."""
    r = (-w.wait_p99 * (cur.wait_p99 - prev.wait_p99) / w.wait_scale
         + w.utilization * (cur.utilization - prev.utilization)
         - w.backlog * (cur.backlog - prev.backlog) / w.backlog_scale)
    return float(np.clip(r, -w.clip, w.clip))


@dataclasses.dataclass
class EpisodeStats:
    """Outcome of one cut episode."""

    steps: int                  # recorded PPO decisions
    windows: int                # rescan windows in the episode
    reward_sum: float
    loss: float
    updated: bool               # False while episodes_per_update pools
    terminal: bool              # stream drained (vs. horizon truncation)
    scenario: str = ""


class EpisodeCutter(EngineHooks):
    """Cuts fixed-horizon PPO episodes from a running ``SchedulerEngine``.

    Attach as an engine hook *and* as the service driver's ``on_window``
    callback; call :meth:`flush` once the stream drains.  The prioritizer
    must be the engine's (recording) ``RLPrioritizer`` — its ``record``
    flag is held off for the first ``warmup_windows`` windows so episodes
    start from a warm, congested cluster instead of the idle transient.
    """

    def __init__(self, agent: PPOAgent, prioritizer, *, horizon: int = 12,
                 weights: RewardWeights | None = None,
                 warmup_windows: int = 0,
                 telemetry_window: float = 6 * 3600.0,
                 scenario: str = ""):
        self.agent = agent
        self.pri = prioritizer
        self.horizon = max(int(horizon), 1)
        self.weights = weights or RewardWeights()
        self.warmup_windows = max(int(warmup_windows), 0)
        self.scenario = scenario
        # internal rolling telemetry: never samples on its own (inf
        # interval) — the cutter probes it at window boundaries
        self.telemetry = RollingTelemetry(window=telemetry_window,
                                          sample_interval=math.inf)
        self.episodes: list[EpisodeStats] = []
        self.decisions = 0            # via the engine's per-decision hook
        self._windows_seen = 0        # processed windows incl. warm-up
        self._ep_windows = 0
        self._rewards: list[float] = []   # one entry per recorded step
        self._mark = 0                # rollout length at last boundary
        self._carry = 0.0             # reward from decision-less windows
        self._prev: WindowStats | None = None
        if self.warmup_windows > 0:
            self.pri.record = False

    # ------------------------------------------------------- engine hooks ----
    def on_submit(self, job: Job, now: float) -> None:
        self.telemetry.on_submit(job, now)

    def on_start(self, job: Job, now: float) -> None:
        self.telemetry.on_start(job, now)

    def on_finish(self, job: Job, now: float) -> None:
        self.telemetry.on_finish(job, now)

    def on_requeue(self, job: Job, now: float) -> None:
        self.telemetry.on_requeue(job, now)

    def on_tick(self, now: float, engine: SchedulerEngine) -> None:
        self.telemetry.on_tick(now, engine)

    def on_decision(self, jobs, order, now, engine) -> None:
        self.decisions += 1

    # ------------------------------------------------------------- probing ----
    def _probe(self, engine: SchedulerEngine) -> WindowStats:
        s = self.telemetry.probe(engine.now, engine)
        return WindowStats(time=s.time, wait_p99=s.wait_p99,
                           utilization=s.utilization, backlog=s.queue_len)

    # ------------------------------------------------------------- cutting ----
    def on_window(self, engine: SchedulerEngine, t: float,
                  windows: int) -> None:
        """Service-driver callback: one processed rescan window ended."""
        stats = self._probe(engine)
        self._windows_seen += 1
        if self._windows_seen <= self.warmup_windows:
            if self._windows_seen == self.warmup_windows:
                # warm-up over: start recording from a congested baseline
                self.pri.record = True
                self._prev = stats
                self._mark = self.agent.rollout_len
            return
        prev = self._prev if self._prev is not None else _IDLE
        r = shaped_reward(prev, stats, self.weights) + self._carry
        self._prev = stats
        n_new = self.agent.rollout_len - self._mark
        if n_new > 0:
            self._rewards.extend([r / n_new] * n_new)
            self._mark = self.agent.rollout_len
            self._carry = 0.0
        else:
            self._carry = r    # no decisions this window: defer the reward
        self._ep_windows += 1
        if self._ep_windows >= self.horizon:
            self.cut(terminal=False)

    def cut(self, terminal: bool) -> EpisodeStats | None:
        """Close the current episode and hand it to the agent (GAE update).
        Returns the episode stats, or None if nothing was recorded."""
        T = self.agent.rollout_len
        if T > len(self._rewards):
            # trailing decisions past the last boundary get the carried
            # reward (0.0 if none was pending)
            n = T - len(self._rewards)
            self._rewards.extend([self._carry / n] * n)
            self._carry = 0.0
        elif self._carry and T > 0:
            # decision-less windows at the episode tail: credit their
            # deferred reward to the last recorded step (the most recent
            # decisions produced those windows' outcome) rather than
            # silently dropping it at the cut
            self._rewards[T - 1] += self._carry
            self._carry = 0.0
        windows = self._ep_windows
        if T == 0:
            # nothing recorded: keep any pending carry for the next
            # decision-bearing window (episode numbering just moves on)
            self._reset_episode()
            return None
        rewards = np.asarray(self._rewards[:T], dtype=np.float32)
        boot = 0.0
        if not terminal:
            vals = self.agent.rollout_values
            boot = float(vals[-1]) if vals else 0.0
        upd = self.agent.finish_episode_dense(rewards, bootstrap_value=boot)
        st = EpisodeStats(steps=T, windows=windows,
                          reward_sum=float(rewards.sum()),
                          loss=upd["loss"], updated=bool(upd["updated"]),
                          terminal=terminal, scenario=self.scenario)
        self.episodes.append(st)
        self._reset_episode()
        return st

    def flush(self) -> EpisodeStats | None:
        """Close the trailing partial episode once the stream has drained."""
        if self.agent.rollout_len or self._rewards or self._ep_windows:
            return self.cut(terminal=True)
        return None

    def _reset_episode(self) -> None:
        # NOTE: _carry deliberately survives the reset — a cut() with zero
        # recorded steps must not discard reward deferred from decision-less
        # windows (cuts with steps fold it into the last step first)
        self._rewards = []
        self._mark = 0
        self._ep_windows = 0

"""Core datatypes for the RLTune scheduler.

Jobs and nodes mirror the visible metadata available in the Philly / Helios /
Alibaba traces (Table 4 of the paper): the scheduler is application-agnostic,
so a Job carries *only* user-submitted metadata — never model semantics.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class JobState(enum.Enum):
    """Job lifecycle states.  Transitions between them are *enforced*: the
    legal-move map lives in ``repro_torch.lifecycle.machine`` and every engine /
    controller path goes through ``lifecycle.transition``, which raises on
    an illegal move instead of silently corrupting scheduler state."""

    PENDING = 0      # queued, waiting for a placement
    RUNNING = 1
    COMPLETED = 2
    FAILED = 3
    PAUSED = 4       # checkpointed and suspended; holds no GPUs, not queued
    PREEMPTED = 5    # evicted by the preemption controller (transient)
    MIGRATING = 6    # withdrawn from one cluster, in flight to another


@dataclasses.dataclass(slots=True)
class Job:
    """A DL job as seen by the scheduler (visible features only).

    ``slots=True``: the scheduler hot path reads job fields millions of
    times per stream (batch scoring, feasibility shapes, backfill checks);
    slot access skips the per-instance dict and measurably speeds the
    decision loop."""

    job_id: int
    user: int
    submit_time: float          # seconds since trace start
    runtime: float              # ground-truth runtime (training reward signal)
    est_runtime: float          # user-provided (noisy) estimate, used at eval
    num_gpus: int               # gang-scheduled GPU demand (current target)
    gpu_type: str = "any"       # requested accelerator SKU ("any" = flexible)
    vc: int = 0                 # virtual cluster id
    req_cpus: int = 0           # 0 => inferred from GPU share
    req_mem_gb: float = 0.0     # 0 => inferred from GPU share
    arch: str = ""              # informational only (NOT visible to the agent)
    deadline: float = -1.0      # absolute SLO deadline (seconds); < 0 = none
    # elastic gang bounds: a job is elastic iff 0 < min_gpus < max_gpus;
    # the preemption controller may resize num_gpus inside [min, max]
    min_gpus: int = 0
    max_gpus: int = 0
    # False when the source trace carried no duration for this job — its
    # ``runtime`` is a stand-in (est_runtime or a default) and the runtime
    # predictor, not the declared estimate, should serve its reservations
    duration_known: bool = True

    # -- mutable scheduling state -------------------------------------------------
    state: JobState = JobState.PENDING
    start_time: float = -1.0
    finish_time: float = -1.0
    first_start_time: float = -1.0   # very first RUNNING instant, never reset
    placement: Optional[dict[int, int]] = None   # node_id -> gpus taken
    restarts: int = 0
    progress_at_ckpt: float = 0.0  # fraction of work checkpointed (fault tolerance)
    base_gpus: int = 0             # num_gpus as submitted (runtime reference)

    def __post_init__(self) -> None:
        if self.req_cpus <= 0:
            # GPU-proportionate CPU allocation (Sec. 2 of the paper)
            self.req_cpus = max(1, 4 * self.num_gpus)
        if self.req_mem_gb <= 0:
            self.req_mem_gb = 32.0 * self.num_gpus
        if self.base_gpus <= 0:
            self.base_gpus = self.num_gpus

    @property
    def elastic(self) -> bool:
        """May the scheduler resize this gang?  ``runtime`` is defined at
        ``base_gpus``; work rate scales linearly with the current gang."""
        return 0 < self.min_gpus < self.max_gpus

    @property
    def has_deadline(self) -> bool:
        return self.deadline >= 0.0

    # -- derived metrics ------------------------------------------------------------
    @property
    def wait_time(self) -> float:
        # first_start_time survives preempt/resume cycles; start_time is kept
        # as the legacy alias (the engine only ever sets it once as well)
        started = self.first_start_time if self.first_start_time >= 0 \
            else self.start_time
        if started < 0:
            raise RuntimeError(
                f"job {self.job_id} never started (state={self.state.name}); "
                f"wait_time is undefined")
        return started - self.submit_time

    @property
    def jct(self) -> float:
        if self.finish_time < 0:
            raise RuntimeError(
                f"job {self.job_id} never finished (state={self.state.name}); "
                f"jct is undefined")
        return self.finish_time - self.submit_time

    def bsld(self, tau: float = 10.0) -> float:
        """Bounded slowdown (Feitelson & Rudolph), bound tau seconds."""
        return max(1.0, self.jct / max(self.runtime, tau))

    def clone_pending(self) -> "Job":
        """A fresh PENDING copy (for replaying the same batch through two
        pipelines).  Resets to the *submitted* gang size: a clone of a
        resized elastic job asks for its original demand again."""
        return Job(
            job_id=self.job_id, user=self.user, submit_time=self.submit_time,
            runtime=self.runtime, est_runtime=self.est_runtime,
            num_gpus=self.base_gpus or self.num_gpus, gpu_type=self.gpu_type,
            vc=self.vc, req_cpus=self.req_cpus, req_mem_gb=self.req_mem_gb,
            arch=self.arch, deadline=self.deadline, min_gpus=self.min_gpus,
            max_gpus=self.max_gpus, duration_known=self.duration_known,
        )


@dataclasses.dataclass(slots=True)
class NodeSpec:
    """Static description of one node in a heterogeneous cluster."""

    node_id: int
    gpu_type: str
    num_gpus: int
    num_cpus: int
    mem_gb: float
    # relative speed of this SKU vs the trace's reference GPU; the simulator
    # scales runtimes by 1/speed when a job lands on a faster/slower SKU.
    speed: float = 1.0


@dataclasses.dataclass
class ClusterSpec:
    """A heterogeneous cluster: an ordered list of node specs."""

    nodes: list[NodeSpec]
    name: str = "cluster"

    @property
    def total_gpus(self) -> int:
        return sum(n.num_gpus for n in self.nodes)

    @property
    def gpu_types(self) -> list[str]:
        return sorted({n.gpu_type for n in self.nodes})

    def gpus_of_type(self, t: str) -> int:
        return sum(n.num_gpus for n in self.nodes if n.gpu_type == t)

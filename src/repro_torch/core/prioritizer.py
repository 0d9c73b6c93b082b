"""Queue-prioritizer interface shared by the batch simulator and the
streaming engine (leaf module: keeps repro_torch.core <-> repro_torch.sched acyclic)."""
from __future__ import annotations

from typing import Protocol

import numpy as np

from repro_torch.core.cluster import ClusterState, JobShape, _job_shape
from repro_torch.core.policies import Policy
from repro_torch.core.types import Job


class ShapeTable:
    """Interned job shapes: ``ids`` maps a ``_job_shape`` key to a small
    int, ``shapes[sid]`` is that key back as a ``JobShape``.  Ids are
    handed out in order of first sight and never reused, so the table only
    grows."""

    __slots__ = ("ids", "shapes")

    def __init__(self):
        self.ids: dict[tuple, int] = {}
        self.shapes: list[JobShape] = []

    def intern(self, job: Job) -> int:
        key = _job_shape(job)
        sid = self.ids.get(key)
        if sid is None:
            sid = self.ids[key] = len(self.shapes)
            self.shapes.append(JobShape._make(key))
        return sid


class WindowFields:
    """Contiguous arrays of the hot job fields for one ranking window,
    aligned index-for-index with the job list handed to ``rank``.

    The streaming engine maintains these arrays incrementally alongside its
    indexed pending queue and passes O(1) views per decision, so batch
    scoring never re-gathers Python attributes.  Arrays are read-only by
    convention; integer-valued fields (``num_gpus``, ``user``, ``vc``,
    ``job_id``) are stored as float64 — exact for any realistic value
    (< 2**53), and float keys hash/compare equal to the original ints so
    dict-based policy state (fair-share usage, runtime history) stays
    collision-free.

    ``shape`` holds each row's shape id (an integer array) and ``shapes``
    the shapes by id (``ShapeTable.shapes``; it may hold shapes no row of
    the window has), so shape-dependent queries can run once per distinct
    shape and be gathered to rows.
    """

    __slots__ = ("submit_time", "runtime", "est_runtime", "num_gpus",
                 "user", "vc", "job_id", "shape", "shapes")

    def __init__(self, submit_time: np.ndarray, runtime: np.ndarray,
                 est_runtime: np.ndarray, num_gpus: np.ndarray,
                 user: np.ndarray, vc: np.ndarray, job_id: np.ndarray,
                 shape: np.ndarray, shapes: list[JobShape]):
        self.submit_time = submit_time
        self.runtime = runtime
        self.est_runtime = est_runtime
        self.num_gpus = num_gpus
        self.user = user
        self.vc = vc
        self.job_id = job_id
        self.shape = shape
        self.shapes = shapes

    @classmethod
    def from_jobs(cls, jobs: list[Job]) -> "WindowFields":
        table = ShapeTable()
        return cls(
            np.array([j.submit_time for j in jobs], dtype=np.float64),
            np.array([j.runtime for j in jobs], dtype=np.float64),
            np.array([j.est_runtime for j in jobs], dtype=np.float64),
            np.array([j.num_gpus for j in jobs], dtype=np.float64),
            np.array([j.user for j in jobs], dtype=np.float64),
            np.array([j.vc for j in jobs], dtype=np.float64),
            np.array([j.job_id for j in jobs], dtype=np.float64),
            np.array([table.intern(j) for j in jobs], dtype=np.intp),
            table.shapes,
        )

    def take(self, indices: list[int]) -> "WindowFields":
        """Row-subset copy for wrapper prioritizers that rank a partition
        of the window (e.g. the non-SLA lane) through their base."""
        ix = np.asarray(indices, dtype=np.intp)
        return WindowFields(self.submit_time[ix], self.runtime[ix],
                            self.est_runtime[ix], self.num_gpus[ix],
                            self.user[ix], self.vc[ix], self.job_id[ix],
                            self.shape[ix], self.shapes)


class Prioritizer(Protocol):
    """Ranks the pending queue; index 0 = schedule first.

    Implementations may additionally expose
    ``rank_window(jobs, cluster, now, fields)`` accepting a
    :class:`WindowFields`; the engine uses it when present and falls back
    to ``rank`` otherwise (wrapper prioritizers that reorder sublists keep
    working unchanged)."""

    use_estimates: bool

    def rank(self, jobs: list[Job], cluster: ClusterState, now: float) -> list[int]: ...
    def observe_finish(self, job: Job) -> None: ...


def _order(scores: np.ndarray) -> list[int]:
    """Stable lowest-score-first permutation of a float64 score array."""
    # a stable argsort of a non-decreasing array is the identity
    # permutation — the engine's window arrives sorted by
    # (submit_time, job_id), so e.g. FCFS always takes this exit
    if scores.size > 1 and bool((scores[1:] >= scores[:-1]).all()):
        return list(range(scores.size))
    # .tolist() materializes plain ints ~2x faster than list()
    return np.argsort(scores, kind="stable").tolist()


class PolicyPrioritizer:
    """Adapter: a Table-5 policy as a Prioritizer (lowest score first).

    Scores the window with one ``policy.score_batch`` call over contiguous
    job-field arrays when the policy provides it (all built-in policies do,
    bit-identical to the scalar loop); ``batch=False`` forces the per-job
    ``policy.score`` loop — the retained naive reference path used by the
    differential equivalence tests.
    """

    def __init__(self, policy: Policy, batch: bool = True):
        self.policy = policy
        self.use_estimates = getattr(policy, "use_estimates", False)
        self.batch = batch and hasattr(policy, "score_batch")

    def rank(self, jobs: list[Job], cluster: ClusterState, now: float) -> list[int]:
        if self.batch:
            return _order(self.policy.score_batch(jobs, now))
        scores = [self.policy.score(j, now) for j in jobs]
        return list(np.argsort(scores, kind="stable"))

    def rank_window(self, jobs: list[Job], cluster: ClusterState, now: float,
                    fields: WindowFields | None) -> list[int]:
        """``rank`` with engine-maintained contiguous field arrays."""
        if self.batch:
            return _order(self.policy.score_batch(jobs, now, fields))
        return self.rank(jobs, cluster, now)

    def observe_finish(self, job: Job) -> None:
        self.policy.observe_finish(job)

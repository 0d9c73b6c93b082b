"""Enforced job state machine.

Every lifecycle-aware mutation of ``Job.state`` — engine start/finish/kill
paths, the preemption controller, and cross-cluster migration — goes through
:func:`transition`, which validates the move against :data:`LEGAL_TRANSITIONS`
and raises :class:`IllegalTransition` instead of silently corrupting scheduler
state.  The map mirrors the lifecycle in the paper's service mode plus the
preemption extensions:

    PENDING ──────────────► RUNNING ────► COMPLETED
       │  ▲                 │  │ │
       │  │ (requeue/resume)│  │ └──────► FAILED
       │  └──── PREEMPTED ◄─┘  │
       │  ▲                    └────────► PAUSED
       │  └─────────────────────────────────┘
       └──► MIGRATING ──► PENDING   (admitted on the destination cluster)

``PREEMPTED`` and ``MIGRATING`` are transient: a preempted job is immediately
requeued (``RUNNING → PREEMPTED → PENDING`` in one controller action) because
the backfill loop only considers ``PENDING`` queue entries, and a migrating
job is ``PENDING`` again the instant the destination engine admits it.
``COMPLETED`` / ``FAILED`` are terminal.
"""
from __future__ import annotations

from repro_torch.core.types import Job, JobState

_S = JobState

#: Legal moves.  Keys are source states; values the set of allowed targets.
LEGAL_TRANSITIONS: dict[JobState, frozenset[JobState]] = {
    _S.PENDING:   frozenset({_S.RUNNING, _S.MIGRATING, _S.FAILED}),
    _S.RUNNING:   frozenset({_S.COMPLETED, _S.FAILED, _S.PENDING,
                             _S.PAUSED, _S.PREEMPTED}),
    _S.PAUSED:    frozenset({_S.RUNNING, _S.PENDING, _S.MIGRATING,
                             _S.FAILED}),
    _S.PREEMPTED: frozenset({_S.PENDING, _S.RUNNING, _S.FAILED}),
    _S.MIGRATING: frozenset({_S.PENDING, _S.FAILED}),
    _S.COMPLETED: frozenset(),
    _S.FAILED:    frozenset(),
}


class IllegalTransition(RuntimeError):
    """Raised when a lifecycle move is not in :data:`LEGAL_TRANSITIONS`."""


def check(src: JobState, dst: JobState) -> None:
    """Validate ``src -> dst`` without touching any job."""
    if dst not in LEGAL_TRANSITIONS[src]:
        raise IllegalTransition(
            f"illegal job transition {src.name} -> {dst.name} "
            f"(legal from {src.name}: "
            f"{sorted(s.name for s in LEGAL_TRANSITIONS[src]) or 'none'})")


def transition(job: Job, dst: JobState) -> Job:
    """Validate and apply one state move; returns the job for chaining."""
    check(job.state, dst)
    job.state = dst
    return job

"""repro_torch.lifecycle — preemptive job lifecycle.

Enforced state machine (``machine``), checkpoint-restore cost model
(``costs``), the per-window preemption controller and its policies
(``preemption``), and cross-cluster migration policies (``migration``).
The engine's pause/resume/preempt/resize/migrate entry points live on
``repro_torch.sched.SchedulerEngine``; this package supplies the rules and the
controllers that drive them.
"""
from repro_torch.lifecycle.costs import CkptCostModel
from repro_torch.lifecycle.machine import (LEGAL_TRANSITIONS, IllegalTransition,
                                           check, transition)
from repro_torch.lifecycle.migration import (MigrationEvent,
                                             QueueImbalanceMigration)
from repro_torch.lifecycle.preemption import (ElasticGangPolicy,
                                              PreemptionController,
                                              PreemptionEvent, SloDeadlinePolicy)

__all__ = [
    "CkptCostModel",
    "LEGAL_TRANSITIONS",
    "IllegalTransition",
    "check",
    "transition",
    "MigrationEvent",
    "QueueImbalanceMigration",
    "ElasticGangPolicy",
    "PreemptionController",
    "PreemptionEvent",
    "SloDeadlinePolicy",
]

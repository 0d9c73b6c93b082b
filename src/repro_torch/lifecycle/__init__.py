"""repro_torch.lifecycle — the enforced job state machine (``machine``) and
the checkpoint-restore cost model (``costs``).

The preemption controller and migration policies are not ported yet; the
engine only needs ``transition``, the chaos layer ``CkptCostModel``.
"""
from repro_torch.lifecycle.costs import CkptCostModel
from repro_torch.lifecycle.machine import (LEGAL_TRANSITIONS, IllegalTransition,
                                           check, transition)

__all__ = ["CkptCostModel", "LEGAL_TRANSITIONS", "IllegalTransition", "check",
           "transition"]

"""repro_torch.lifecycle — the enforced job state machine (``machine``).

The checkpoint cost model, preemption controller and migration policies
are not ported yet; the engine only needs ``transition``.
"""
from repro_torch.lifecycle.machine import (LEGAL_TRANSITIONS, IllegalTransition,
                                           check, transition)

__all__ = ["LEGAL_TRANSITIONS", "IllegalTransition", "check", "transition"]

"""repro_torch.sched: the streaming scheduler engine over repro_torch.core.

Scenarios, telemetry and the service drivers are not ported yet."""
from repro_torch.sched.engine import (DEFAULT_QUEUE_WINDOW, EngineHooks,
                                      EngineSnapshot, MultiHooks,
                                      PolicyPrioritizer, Prioritizer,
                                      SchedulerEngine)

__all__ = [
    "DEFAULT_QUEUE_WINDOW", "EngineHooks", "EngineSnapshot", "MultiHooks",
    "PolicyPrioritizer", "Prioritizer", "SchedulerEngine",
]

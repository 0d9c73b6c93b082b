"""repro_torch.scale: telemetry-driven autoscaling — elastic capacity controllers
closing the loop from rolling telemetry to cluster size (see
docs/ARCHITECTURE.md "Autoscaling layer")."""
from repro_torch.scale.autoscaler import (AUTOSCALERS, Autoscaler, PoolSpec,
                                          QueuePressureAutoscaler, ScaleEvent,
                                          TargetUtilizationAutoscaler,
                                          list_autoscalers, make_autoscaler,
                                          pools_from_spec)

__all__ = [
    "AUTOSCALERS", "Autoscaler", "PoolSpec", "QueuePressureAutoscaler",
    "ScaleEvent", "TargetUtilizationAutoscaler", "list_autoscalers",
    "make_autoscaler", "pools_from_spec",
]

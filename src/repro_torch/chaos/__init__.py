"""Chaos fault injection and graceful control-plane degradation.

Correlated failure bursts, spot-reclamation waves, straggler storms and
federation blackouts (``ChaosSchedule`` + injectors), plus the degradation
ladder the control plane falls down when decision latency blows its
budget (``DegradationPolicy``).  This package imports only ``repro_torch.core``
and ``repro_torch.lifecycle`` — never ``repro_torch.sched``/``repro_torch.fed``, which
import *it* — so the engine stays chaos-agnostic behind duck-typed hooks.
"""
from repro_torch.chaos.degradation import DegradationPolicy
from repro_torch.chaos.schedule import (
    SPOT_RECLAMATION_COST,
    ChaosAction,
    ChaosEvent,
    ChaosInjector,
    ChaosSchedule,
    FleetChaosInjector,
)

__all__ = [
    "SPOT_RECLAMATION_COST",
    "ChaosAction",
    "ChaosEvent",
    "ChaosInjector",
    "ChaosSchedule",
    "DegradationPolicy",
    "FleetChaosInjector",
]

"""repro_torch.sched: streaming scheduler engine, scenario suite, and service
drivers layered over repro_torch.core."""
from repro_torch.sched.engine import (DEFAULT_QUEUE_WINDOW, EngineHooks,
                                      EngineSnapshot, MultiHooks,
                                      PolicyPrioritizer, Prioritizer,
                                      SchedulerEngine)
from repro_torch.sched.scenarios import (SCENARIOS, Scenario, ScenarioRun,
                                         get_scenario, list_scenarios,
                                         register)
from repro_torch.sched.service import (QuotaPrioritizer, SlaLanePrioritizer,
                                       StreamResult, run_scenario, run_stream,
                                       wrap_tenancy)
from repro_torch.sched.telemetry import (RollingTelemetry, TelemetrySample,
                                         jain_index)

__all__ = [
    "DEFAULT_QUEUE_WINDOW", "EngineHooks", "EngineSnapshot", "MultiHooks",
    "PolicyPrioritizer", "Prioritizer", "SchedulerEngine", "SCENARIOS",
    "Scenario", "ScenarioRun", "get_scenario", "list_scenarios", "register",
    "QuotaPrioritizer", "SlaLanePrioritizer", "StreamResult", "run_scenario",
    "run_stream", "wrap_tenancy", "RollingTelemetry", "TelemetrySample",
    "jain_index",
]

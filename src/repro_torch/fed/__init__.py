"""repro_torch.fed: multi-cluster federation — a meta-scheduler routing streaming
jobs across per-cluster SchedulerEngines via snapshot-only routing policies
(see docs/ARCHITECTURE.md, "Federation layer")."""
from repro_torch.fed.federation import (FederatedScheduler, FleetResult,
                                        FleetSnapshot, FleetStreamResult,
                                        run_fleet)
from repro_torch.fed.router import (ROUTERS, ClusterInfo, ClusterView, Router,
                                    capable_clusters, list_routers,
                                    make_router)
from repro_torch.fed.scenarios import (FLEET_SCENARIOS, FleetRun,
                                       FleetScenario, get_fleet_scenario,
                                       list_fleet_scenarios, merge_streams,
                                       register_fleet)

__all__ = [
    "FederatedScheduler", "FleetResult", "FleetSnapshot", "FleetStreamResult",
    "run_fleet", "ROUTERS", "ClusterInfo", "ClusterView", "Router",
    "capable_clusters", "list_routers", "make_router", "FLEET_SCENARIOS",
    "FleetRun", "FleetScenario", "get_fleet_scenario", "list_fleet_scenarios",
    "merge_streams", "register_fleet",
]

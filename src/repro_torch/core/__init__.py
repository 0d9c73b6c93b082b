"""RLTune core on torch: hybrid RL + MILP dynamic scheduling.

The serving half only: the PPO trainer is not ported yet.
"""
from repro_torch.core.agent import PPOAgent, PPOConfig
from repro_torch.core.cluster import ClusterState
from repro_torch.core.env import InspectorPrioritizer, RLPrioritizer
from repro_torch.core.faults import FaultInjector, FaultModel
from repro_torch.core.metrics import BatchResult, reward_from_scores
from repro_torch.core.milp import MILPResult, choose_allocation
from repro_torch.core.policies import BASE_POLICIES, make_policy
from repro_torch.core.simulator import PolicyPrioritizer, Simulator
from repro_torch.core.trace import (ALIBABA, HELIOS, PHILLY, PROFILES,
                                    batch_iter, generate_trace,
                                    load_trace_csv, make_cluster,
                                    train_eval_split)
from repro_torch.core.types import ClusterSpec, Job, JobState, NodeSpec

__all__ = [
    "PPOAgent", "PPOConfig", "ClusterState", "InspectorPrioritizer",
    "RLPrioritizer", "FaultInjector", "FaultModel", "BatchResult",
    "reward_from_scores", "MILPResult", "choose_allocation", "BASE_POLICIES",
    "make_policy", "PolicyPrioritizer", "Simulator", "ALIBABA", "HELIOS",
    "PHILLY", "PROFILES", "batch_iter", "generate_trace", "load_trace_csv",
    "make_cluster", "train_eval_split", "ClusterSpec", "Job", "JobState",
    "NodeSpec",
]

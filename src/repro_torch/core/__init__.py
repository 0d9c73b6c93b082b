"""RLTune core on torch: hybrid RL + MILP dynamic scheduling (the paper's
contribution), serving and PPO training."""
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

#: trainer names are re-exported lazily (PEP 562): the batch trainer lives
#: in repro_torch.rl.batch, which imports repro_torch.core submodules, so an
#: eager import here would be circular whichever package loads first.
_LAZY_TRAINER = ("RLTuneTrainer", "TrainerConfig", "EpochStats",
                 "improvement")


def __getattr__(name: str):
    if name in _LAZY_TRAINER:
        from repro_torch.core import trainer
        return getattr(trainer, name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute "
                         f"{name!r}")


__all__ = [
    "PPOAgent", "PPOConfig", "ClusterState", "InspectorPrioritizer",
    "RLPrioritizer", "FaultInjector", "FaultModel", "BatchResult",
    "reward_from_scores", "MILPResult", "choose_allocation", "BASE_POLICIES",
    "make_policy", "PolicyPrioritizer", "Simulator", "ALIBABA", "HELIOS",
    "PHILLY", "PROFILES", "batch_iter", "generate_trace", "load_trace_csv",
    "make_cluster", "train_eval_split", "RLTuneTrainer", "TrainerConfig",
    "improvement", "ClusterSpec", "Job", "JobState", "NodeSpec",
]

"""Trace-driven discrete-event cluster simulator (Sec. 4.1).

Mimics a Slurm-like scheduler loop: jobs arrive, a prioritizer ranks the
queue at every decision point, the allocator (MILP / pack / spread) maps the
top job to nodes, EASY backfilling fills holes without delaying the reserved
top job, and completions free resources.  Heterogeneity: placements on
faster/slower SKUs scale the job's wall runtime.  Optional fault injection
(node failures, stragglers) exercises checkpoint/restart and re-queueing.

Ground-truth runtimes drive the simulation clock; user estimates are only
used by policies/backfill when `use_estimates=True` (evaluation realism).

The event loop itself lives in ``repro_torch.sched.engine.SchedulerEngine`` (the
streaming service mode); ``Simulator.run_batch`` is a thin batch-semantics
wrapper over it — submit everything upfront, run to completion from an idle
cluster — and is bit-identical to the pre-extraction implementation on
fixed seeds.  ``Prioritizer`` / ``PolicyPrioritizer`` are re-exported here
for backwards compatibility.
"""
from __future__ import annotations

from repro_torch.core.faults import FaultModel
from repro_torch.core.metrics import BatchResult
from repro_torch.core.prioritizer import PolicyPrioritizer, Prioritizer
from repro_torch.core.types import ClusterSpec, Job

__all__ = ["Prioritizer", "PolicyPrioritizer", "Simulator"]


class Simulator:
    """Discrete-event simulator for one cluster (batch semantics)."""

    def __init__(
        self,
        spec: ClusterSpec,
        *,
        allocator: str = "milp",          # "milp" | "pack" | "spread" | "greedy"
        backfill: bool = True,
        lookahead_k: int = 8,
        fault_model: FaultModel | None = None,
        straggler_migration: bool = True,
        max_sim_time: float = 90 * 86400.0,
        queue_window: int | None = None,   # None = engine default (2560)
        optimized: bool = True,            # False = naive reference engine
    ):
        self.spec = spec
        self.allocator = allocator
        self.backfill = backfill
        self.lookahead_k = lookahead_k
        self.fault_model = fault_model
        self.straggler_migration = straggler_migration
        self.max_sim_time = max_sim_time
        self.queue_window = queue_window
        self.optimized = optimized

    def make_engine(self, prioritizer: Prioritizer) -> "SchedulerEngine":
        """A fresh streaming engine configured like this simulator."""
        # imported lazily: repro_torch.sched layers on top of repro_torch.core, so the
        # core package must be importable without sched being initialized
        from repro_torch.sched.engine import SchedulerEngine
        return SchedulerEngine(
            self.spec, prioritizer, allocator=self.allocator,
            backfill=self.backfill, lookahead_k=self.lookahead_k,
            fault_model=self.fault_model,
            straggler_migration=self.straggler_migration,
            max_sim_time=self.max_sim_time, queue_window=self.queue_window,
            optimized=self.optimized,
        )

    # ------------------------------------------------------------------ run ----
    def run_batch(self, jobs: list[Job], prioritizer: Prioritizer,
                  start_idle: bool = True) -> BatchResult:
        """Schedule `jobs` to completion from an idle cluster; returns metrics."""
        assert start_idle
        engine = self.make_engine(prioritizer)
        engine.submit(jobs)
        engine.run_until_complete()
        return engine.result()

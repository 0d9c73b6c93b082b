"""Checkpoint-restore cost model for preemption and migration.

Preempting a running job is not free: the next start replays work since the
last checkpoint (handled by the engine's ckpt-floor arithmetic, identical to
the fault path) *and* pays a restore penalty — container restart, checkpoint
download, optimizer-state resharding — that grows with gang size.  The
constants mirror the ``repro_torch.ckpt`` layer: ``ckpt_interval`` matches
``FaultModel.ckpt_interval`` / ``CheckpointManager(interval=...)`` so
preemption and fault kills floor progress to the same checkpoint grid.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.types import Job


@dataclasses.dataclass(frozen=True)
class CkptCostModel:
    """Cost constants charged when a job is preempted / migrated.

    ``resume_penalty`` is expressed in *work seconds at reference speed*
    (the unit of ``Job.runtime`` / ``engine.remaining``): it is added to the
    job's remaining work, so a slow SKU stretches it like any other work.
    """

    ckpt_interval: float = 1800.0       # periodic checkpoint cadence (s)
    restore_s: float = 120.0            # fixed restart cost per resume
    per_gpu_restore_s: float = 2.0      # resharding cost per gang GPU

    def resume_penalty(self, job: Job) -> float:
        """Work-seconds charged when ``job`` next resumes."""
        return self.restore_s + self.per_gpu_restore_s * job.num_gpus

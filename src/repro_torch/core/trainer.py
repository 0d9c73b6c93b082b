"""Import surface for the batch RLTune trainer, as ``repro.core.trainer``.

The RL training stack lives in ``repro_torch.rl``: the batch-pair pipeline in
``repro_torch.rl.batch`` (the terminal-reward special case of the streaming
machinery) and ``repro_torch.rl.trainer.StreamingTrainer`` (the
streaming-episode pathway).  This module re-exports the batch classes, and
``repro_torch.core`` resolves the same names lazily through it.
"""
from repro_torch.rl.batch import (EpochStats, RLTuneTrainer, TrainerConfig,
                                  improvement)

__all__ = ["EpochStats", "RLTuneTrainer", "TrainerConfig", "improvement"]

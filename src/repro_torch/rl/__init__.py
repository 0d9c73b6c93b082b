"""repro_torch.rl: the RL training stack on the streaming scheduler engine.

- ``repro_torch.rl.episodes`` — ``EpisodeCutter`` slices a running
  ``SchedulerEngine`` into fixed-horizon PPO episodes with dense shaped
  rewards from rolling-telemetry deltas.
- ``repro_torch.rl.trainer`` — ``StreamingTrainer`` samples episodes from the
  registered scenario distribution and evaluates greedily through
  ``service.run_stream``.
- ``repro_torch.rl.batch`` — the legacy batch-pair trainer (``RLTuneTrainer``),
  the terminal-reward special case; re-exported by
  ``repro_torch.core.trainer``.
"""
from repro_torch.rl.batch import (EpochStats, RLTuneTrainer, TrainerConfig,
                                  improvement)
from repro_torch.rl.episodes import (EpisodeCutter, EpisodeStats,
                                     RewardWeights, WindowStats,
                                     shaped_reward)
from repro_torch.rl.trainer import StreamingConfig, StreamingTrainer

__all__ = [
    "EpochStats", "RLTuneTrainer", "TrainerConfig", "improvement",
    "EpisodeCutter", "EpisodeStats", "RewardWeights", "WindowStats",
    "shaped_reward", "StreamingConfig", "StreamingTrainer",
]

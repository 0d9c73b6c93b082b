"""repro_torch.predict — online runtime prediction for scheduling decisions.

See ``repro_torch.predict.predictor`` for the model and training loop, and
``docs/ARCHITECTURE.md`` ("Prediction layer") for how the estimates feed
EASY backfill reservations, MILP lookahead durations, and autoscaler
demand forecasts.
"""
from repro_torch.predict.predictor import (CONTEXT_NAMES, NUM_CONTEXT,
                                     PREDICT_FEATURES, RESID_CLAMP,
                                     OverrunPolicy, QuantileMLP,
                                     RunningMeanBaseline, RuntimePredictor)

__all__ = [
    "CONTEXT_NAMES", "NUM_CONTEXT", "PREDICT_FEATURES", "RESID_CLAMP",
    "OverrunPolicy", "QuantileMLP", "RunningMeanBaseline",
    "RuntimePredictor",
]

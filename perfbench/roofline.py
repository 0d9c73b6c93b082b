"""The least time one H100 could take for a launch of the two scheduler
kernels, from their shapes: frozen copies of the bounds the program's
kernel benches use (``benchmarks_torch/kernel_timing.py``), so that the
yardstick does not move with the program.

A bound is the larger of the operations the launch must do (2 per
multiply-add) over the f32 peak outside the tensor cores and of its bytes
(every input read once, the output written once) over the memory rate.
Rates: the H100 SXM data sheet, dense, at its 700 W limit.
"""
from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def _bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def policy_mlp_s(Q: int, n_live: int, F: int = 8, H1: int = 64,
                 H2: int = 32) -> float:
    """The masked actor MLP over Q rows of which ``n_live`` are unmasked:
    the live rows' operations, or x, the mask, the output and the weights
    moved once."""
    flops = 2.0 * (F * H1 + H1 * H2 + H2) * n_live
    nbytes = 4.0 * (Q * F + Q + Q + F * H1 + H1 + H1 * H2 + 2 * H2 + 1)
    return _bound_s(flops, nbytes)


def predict_mlp_s(B: int, F: int = 21, H1: int = 24, H2: int = 12,
                  Q: int = 2) -> float:
    """The predictor's quantile MLP over B rows: its operations, or x, the
    output and the weights moved once."""
    flops = 2.0 * (F * H1 + H1 * H2 + H2 * Q) * B
    nbytes = 4.0 * (B * F + B * Q + F * H1 + H1 + H1 * H2 + H2 + H2 * Q + Q)
    return _bound_s(flops, nbytes)

"""Dispatch for the port's kernels.

CPU tensors go to the plain version in ``ref``, CUDA tensors to the
hand-written kernel; anything else raises.  There is no fallback from one to
the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import policy_mlp as _policy_mlp
from repro_torch.kernels import predict_mlp as _predict_mlp
from repro_torch.kernels.ref import policy_mlp_ref, predict_mlp_ref


def _device_type(kernel: str, *tensors: torch.Tensor) -> str:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: tensors on several devices: "
                         f"{sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no {kernel} path for device type {kind!r}")
    return kind


def policy_mlp(x: torch.Tensor, params: list[dict], mask: torch.Tensor) -> torch.Tensor:
    """Actor forward over the queue. ``params`` is the actor's three
    ``{"w", "b"}`` layers (``PPOAgent.params["actor"]``); (Q, F), (Q,) ->
    masked logits (Q,) f32."""
    args = (x, params[0]["w"], params[0]["b"], params[1]["w"],
            params[1]["b"], params[2]["w"], params[2]["b"], mask)
    if _device_type("policy_mlp", *args) == "cuda":
        return _policy_mlp.policy_mlp(*args)
    return policy_mlp_ref(*args)


def predict_mlp(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Runtime-predictor forward. ``params`` holds the ``QuantileMLP``
    weights as tensors (keys w1/b1/w2/b2/w3/b3); (B, F) -> per-quantile
    log-runtime residuals (B, Q) f32."""
    args = (x, params["w1"], params["b1"], params["w2"], params["b2"],
            params["w3"], params["b3"])
    if _device_type("predict_mlp", *args) == "cuda":
        return _predict_mlp.predict_mlp(*args)
    return predict_mlp_ref(*args)

"""Dispatch for the port's kernels.

CPU tensors go to the plain version in ``ref``, CUDA tensors to the
hand-written kernel; anything else raises.  There is no fallback from one to
the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import moe_router as _moe_router
from repro_torch.kernels import policy_mlp as _policy_mlp
from repro_torch.kernels import predict_mlp as _predict_mlp
from repro_torch.kernels import ssd_scan as _ssd_scan
from repro_torch.kernels.ref import (flash_attention_ref, moe_router_ref,
                                     policy_mlp_ref, predict_mlp_ref,
                                     ssd_scan_ref)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal / sliding-window GQA attention. q (B, H, L, D); k, v
    (B, KV, L, D) -> (B, H, L, D) in q's dtype."""
    if _device_type("flash_attention", q, k, v) == "cuda":
        return _flash_attention.flash_attention(q, k, v, causal=causal,
                                                window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bs: torch.Tensor, Cs: torch.Tensor, *, chunk: int = 256,
             init_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan in the layout of ``models.mamba.ssd_chunked``:
    xh (B, L, H, P); dt (B, L, H); A (H,); Bs/Cs (B, L, N); init_state
    (B, H, P, N) or None -> (y (B, L, H, P), final state (B, H, P, N) f32).
    As in the reference, L must be a multiple of ``chunk`` or shorter than
    it; the result does not depend on ``chunk`` otherwise."""
    L = xh.shape[1]
    if L % min(chunk, L):
        raise ValueError(f"ssd_scan: L={L} is neither a multiple of the "
                         f"chunk {chunk} nor shorter than it")
    args = (xh, dt, A, Bs, Cs) + (() if init_state is None else (init_state,))
    if _device_type("ssd_scan", *args) == "cuda":
        return _ssd_scan.ssd_scan(xh, dt, A, Bs, Cs, init_state)
    return ssd_scan_ref(xh, dt, A, Bs, Cs, init_state)


def moe_router(x: torch.Tensor, router_w: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused router: x (T, d), router_w (d, E) -> (weights (T, k) f32,
    expert indices (T, k) int32), ties to the lowest expert index."""
    if _device_type("moe_router", x, router_w) == "cuda":
        return _moe_router.moe_router(x, router_w, k)
    return moe_router_ref(x, router_w, k)

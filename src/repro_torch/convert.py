"""Carry weights between ``repro`` (JAX) and ``repro_torch``.

Both packages describe the agent's parameters the same way:
``{"actor": [{"w", "b"}, ...], "critic": [...]}`` with ``w`` in
``(fan_in, fan_out)`` layout.  ``repro.core.agent.PPOAgent.state_dict()``
gives them as nested numpy arrays under ``"params"``; these helpers copy
that form into the port's modules and back, without transposes, so both
packages compute the same function.  The runtime predictor's
``QuantileMLP.params`` (numpy w1/b1/w2/b2/w3/b3) is the same in both
packages and is copied array by array.
"""
from __future__ import annotations

import numpy as np
import torch


def params_to_numpy(net) -> dict:
    """A module with the reference's ``params`` view (``ActorCritic``) ->
    nested float32 numpy arrays."""
    return {name: [{k: t.detach().cpu().numpy().copy() for k, t in lyr.items()}
                   for lyr in layers]
            for name, layers in net.params.items()}


def load_numpy_params(net, params: dict) -> None:
    """Copy nested numpy parameters into ``net`` in place (on its device).
    Raises if a network, layer count or shape differs."""
    mine = net.params
    if set(mine) != set(params):
        raise ValueError(f"networks {sorted(params)} do not match "
                         f"{sorted(mine)}")
    for name, layers in mine.items():
        if len(layers) != len(params[name]):
            raise ValueError(f"{name}: {len(params[name])} layers, expected "
                             f"{len(layers)}")
        for i, (dst, src) in enumerate(zip(layers, params[name])):
            for k in ("w", "b"):
                arr = np.asarray(src[k], dtype=np.float32)
                if tuple(arr.shape) != tuple(dst[k].shape):
                    raise ValueError(f"{name}[{i}].{k}: shape {arr.shape}, "
                                     f"expected {tuple(dst[k].shape)}")
                with torch.no_grad():
                    dst[k].copy_(torch.tensor(arr))


def load_quantile_mlp_params(mlp, params: dict) -> None:
    """Copy a ``QuantileMLP.params`` dict (numpy w1/b1/w2/b2/w3/b3, as the
    reference's ``repro.predict.QuantileMLP`` holds it) into the port's
    ``QuantileMLP`` ``mlp``.  The arrays are copied, never aliased, and
    ``mlp.updates`` moves so a predictor re-uploads its device copy.
    Raises if a key or shape differs."""
    mine = mlp.params
    if set(mine) != set(params):
        raise ValueError(f"QuantileMLP keys {sorted(params)} do not match "
                         f"{sorted(mine)}")
    for k, dst in mine.items():
        arr = np.asarray(params[k], dtype=np.float32)
        if arr.shape != dst.shape:
            raise ValueError(f"QuantileMLP.{k}: shape {arr.shape}, expected "
                             f"{dst.shape}")
    for k, dst in mine.items():
        dst[...] = np.asarray(params[k], dtype=np.float32)
    mlp.updates += 1

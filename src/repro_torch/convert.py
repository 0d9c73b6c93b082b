"""Carry policy weights between ``repro`` (JAX) and ``repro_torch``.

Both packages describe the agent's parameters the same way:
``{"actor": [{"w", "b"}, ...], "critic": [...]}`` with ``w`` in
``(fan_in, fan_out)`` layout.  ``repro.core.agent.PPOAgent.state_dict()``
gives them as nested numpy arrays under ``"params"``; these helpers copy
that form into the port's modules and back, without transposes, so both
packages compute the same function.
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

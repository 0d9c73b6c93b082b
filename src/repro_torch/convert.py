"""Carry weights between ``repro`` (JAX) and ``repro_torch``.

Both packages describe the agent's parameters the same way:
``{"actor": [{"w", "b"}, ...], "critic": [...]}`` with ``w`` in
``(fan_in, fan_out)`` layout.  ``repro.core.agent.PPOAgent.state_dict()``
gives them as nested numpy arrays under ``"params"``; these helpers copy
that form into the port's modules and back, without transposes, so both
packages compute the same function.  The runtime predictor's
``QuantileMLP.params`` (numpy w1/b1/w2/b2/w3/b3) is the same in both
packages and is copied array by array.  ``lm_params_from_jax`` carries the
reference ``LM``'s parameter tree (layers stacked on a leading dim) into the
port's per-layer tensors.
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


def _tensor_from_numpy(a) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype.  bf16 arrays (numpy
    arrays of ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses)
    go through a ``uint16`` view of their bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def lm_params_from_jax(params_np: dict, model, device=None) -> dict:
    """The reference ``LM``'s parameters as the port's ``model`` holds them.

    ``params_np`` is the reference's nested tree as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), whose layer stacks carry a
    leading layer dim; each stack becomes the port's list of per-layer
    dicts.  Tensors go to ``device`` (default ``model.device``).  Raises if
    a key, shape or dtype differs from the port's schema."""
    from repro_torch.models.layers import ParamSpec, stack_schema
    dev = model.device if device is None else torch.device(device)

    def check(src, sch, path: str) -> None:
        if isinstance(sch, ParamSpec):
            t = np.asarray(src)
            if tuple(t.shape) != sch.shape:
                raise ValueError(f"{path}: shape {t.shape}, expected {sch.shape}")
            if t.dtype.name != str(sch.dtype).removeprefix("torch."):
                raise TypeError(f"{path}: dtype {t.dtype}, expected {sch.dtype}")
            return
        if set(src) != set(sch):
            raise ValueError(f"{path}: keys {sorted(src)} do not match "
                             f"{sorted(sch)}")
        for k in sch:
            check(src[k], sch[k], f"{path}.{k}")

    def take(src, i: int):
        if isinstance(src, dict):
            return {k: take(v, i) for k, v in src.items()}
        return np.asarray(src)[i]

    def walk(src, sch, path: str):
        if isinstance(sch, ParamSpec):
            check(src, sch, path)
            return _tensor_from_numpy(src).to(dev)
        if isinstance(sch, list):           # a stack of layers
            check(src, stack_schema(sch[0], len(sch)), path)
            return [walk(take(src, i), s, f"{path}[{i}]")
                    for i, s in enumerate(sch)]
        if set(src) != set(sch):
            raise ValueError(f"{path}: keys {sorted(src)} do not match "
                             f"{sorted(sch)}")
        return {k: walk(src[k], sch[k], f"{path}.{k}") for k in sch}

    return walk(params_np, model.schema(), "params")

"""AdamW over a parameter tree of tensors, updated in place.

As in the reference: params live in their own dtype (bf16 for the LM
configs), Adam moments are f32 with the params' tree, and there is no
separate f32 master copy — the update is computed in f32 from the param and
cast back (≈10 bytes of state per bf16 param).  lr schedule: linear warmup
+ cosine decay.  The update writes params and moments in place under
``torch.no_grad()``, the counterpart of the reference's buffer donation.

Sharded (DTensor) params, moments and gradients: each gradient is first
redistributed to its param's placements (from autograd's partial sums: a
reduce-scatter or all-reduce), the global norm sums every leaf's local
squares over the mesh dims it is sharded on, and the update then runs on
the local shards alone.  On a 1x1 mesh that is the unsharded update bit for
bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """lr at ``step`` (an integer tensor) as an f32 tensor on its device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def tree_leaves(tree) -> Iterator[tuple[tuple, torch.Tensor]]:
    """(path, tensor) of every leaf of a nested dict/list tree, dict keys
    sorted (the reference's flatten order within one layer)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for path, leaf in tree_leaves(tree[k]):
                yield (k,) + path, leaf
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            for path, leaf in tree_leaves(sub):
                yield (i,) + path, leaf
    else:
        yield (), tree


def map_tree(fn, tree) -> Any:
    """``fn`` applied to every leaf, keeping the nesting."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def abstract_opt_state(abstract_params) -> dict:
    """The optimizer state's tree on the ``meta`` device (the dry run)."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return {"m": map_tree(f32, abstract_params),
            "v": map_tree(f32, abstract_params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def opt_specs(param_specs) -> dict:
    """Moments share the params' specs (fully sharded states)."""
    from repro_torch.sharding.specs import PS
    return {"m": param_specs, "v": param_specs, "step": PS()}


def opt_init(params) -> dict:
    """Moments in f32 with the params' tree, device and (for DTensors)
    placements; step counter a 0-d int32 tensor."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    dev = next(tree_leaves(params))[1].device
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def decay_mask(path: tuple) -> bool:
    """No weight decay on norms/biases/scalars: the reference's substring
    test on the leaf's own key (it tests ``str(DictKey)``, ``"['scale']"``,
    whose brackets and quotes hold none of the substrings)."""
    leaf_name = str(path[-1]) if path else ""
    return not any(s in leaf_name for s in ("scale", "bias", "A_log", "D",
                                            "dt_bias"))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: in-place writes reach the DTensor);
    a plain tensor itself."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _sumsq(g: torch.Tensor) -> torch.Tensor:
    """Sum of squares of a gradient in f32; of a DTensor, its local shard's
    summed over the mesh dims it is sharded on (a plain 0-d tensor)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    local = torch.sum(torch.square(_local(g).float()))
    if not isinstance(g, DTensor):
        return local
    return DTensor.from_local(
        local, g.device_mesh,
        [Partial() if pl.is_shard() else Replicate() for pl in g.placements],
        run_check=False).full_tensor()


@torch.no_grad()
def opt_update(params, grads, state: dict, cfg: OptConfig):
    """One AdamW step, in place.  ``grads`` has the params' tree (f32 or
    castable).  Returns (params, state, {gnorm, lr}) — the same objects,
    updated; the stats are 0-d device tensors (no synchronisation)."""
    from torch.distributed.tensor import DTensor
    step = _local(state["step"]) + 1
    lr = schedule(cfg, step)
    g_leaves = [g.redistribute(p.device_mesh, p.placements)
                if isinstance(g, DTensor) else g
                for (_, p), (_, g) in zip(tree_leaves(params),
                                          tree_leaves(grads))]
    gnorm = torch.sqrt(sum(_sumsq(g) for g in g_leaves))
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    for (path, p), g, (_, m), (_, v) in zip(
            tree_leaves(params), g_leaves, tree_leaves(state["m"]),
            tree_leaves(state["v"])):
        p, g, m, v = _local(p), _local(g), _local(m), _local(v)
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        if decay_mask(path):
            upd = upd + cfg.weight_decay * pf
        p.copy_(pf - lr * upd)
    _local(state["step"]).copy_(step)
    return params, state, {"gnorm": gnorm, "lr": lr}

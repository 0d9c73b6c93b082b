"""GPipe-style pipeline parallelism over a process group (point-to-point).

Used when the `pod` axis is repurposed as a pipeline axis: each member of
the group holds a contiguous slice of layers; microbatches stream through
the stages, each tick handing its activation to the next stage on a ring
of ``dist.batch_isend_irecv``.  The schedule keeps every stage busy but for
the (S-1)-tick bubble at the ends, the classic GPipe trade-off.  It is the
reference's schedule tick for tick: stage 0 injects microbatch t, the last
stage records microbatch t - (S-1), and the finished outputs are broadcast
from the last stage.

This module is self-contained (any group; ``make_pipelined_apply`` takes a
mesh axis); tests run it on 4 ranks.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _ring_shift(y: torch.Tensor, group, stage: int, S: int) -> torch.Tensor:
    """Send ``y`` to stage + 1 and receive stage - 1's (mod S): the
    reference's ``ppermute`` over ``[(i, (i + 1) % S)]``."""
    buf = torch.empty_like(y)
    ranks = dist.get_process_group_ranks(group) if group is not None \
        else list(range(S))
    ops = [dist.P2POp(dist.isend, y, ranks[(stage + 1) % S], group),
           dist.P2POp(dist.irecv, buf, ranks[(stage - 1) % S], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf


def pipeline_forward(stage_fn: Callable, h: torch.Tensor, stage_params,
                     *, group=None, num_microbatches: int) -> torch.Tensor:
    """h (M, mb, L, d): every stage passes the same microbatched input.

    ``stage_fn(params, x) -> x`` applies THIS stage's layer slice, whose
    parameters are ``stage_params``; this process is stage
    ``dist.get_rank(group)`` of ``dist.get_world_size(group)``.  Returns
    the outputs in microbatch order, on every stage (broadcast from the
    last)."""
    M = num_microbatches
    S = dist.get_world_size(group)
    stage = dist.get_rank(group)
    buf = torch.zeros_like(h[0])
    outs = torch.zeros_like(h)
    for t in range(M + S - 1):                 # total pipeline ticks
        x_in = h[min(t, M - 1)] if stage == 0 else buf
        y = stage_fn(stage_params, x_in)
        if stage == S - 1 and t >= S - 1:
            outs[t - (S - 1)] = y
        buf = _ring_shift(y, group, stage, S) if S > 1 else y
    last = dist.get_global_rank(group, S - 1) if group is not None else S - 1
    dist.broadcast(outs, src=last, group=group)
    return outs


def make_pipelined_apply(stage_fn: Callable, mesh, *, axis_name: str = "pod",
                         num_microbatches: int = 4):
    """Wrap a per-stage layer fn into a full pipelined apply over the mesh
    axis ``axis_name`` (a ``DeviceMesh``): ``apply(stacked_params, h)``
    takes params stacked (S, ...) on every rank (this stage uses slice
    ``stage``) and the full (M, mb, L, d) input, and returns the outputs
    on every rank."""
    group = mesh.get_group(axis_name)

    def apply(stacked_params, h):
        stage = dist.get_rank(group)
        own = _slice(stacked_params, stage)
        return pipeline_forward(stage_fn, h, own, group=group,
                                num_microbatches=num_microbatches)

    return apply


def _slice(tree, i: int):
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_slice(v, i) for v in tree)
    return tree[i]

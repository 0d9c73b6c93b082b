"""train_step / eval_step factories.

Gradients come from autograd over the parameter leaves (the loss is
rematerialized layer by layer, see ``models.lm``); with microbatches they
accumulate in f32 and the loss and gradients are divided by the count, as
the reference's ``lax.scan`` over microbatches does.  The optimizer then
updates params and moments in place.  Metrics stay 0-d device tensors, so
a step never synchronises with the host.  Sharding (`jit_train_step`) is
not ported.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.lm import LM
from repro_torch.train.optimizer import OptConfig, opt_update, tree_leaves


def _split_microbatches(batch: dict, k: int) -> list[dict]:
    return [{key: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]
             for key, x in batch.items()} for i in range(k)]


def make_train_step(model: LM, opt_cfg: OptConfig, *, microbatches: int = 1
                    ) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): one optimizer step on ``batch`` (a dict of tensors on the
    params' device), params and state updated in place."""

    def grads_of(leaves: list[torch.Tensor], params, batch):
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss = model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        return loss.detach(), grads

    def train_step(params, opt_state, batch):
        leaves = [t for _, t in tree_leaves(params)]
        if microbatches > 1:
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                   for t in leaves]
            for mb in _split_microbatches(batch, microbatches):
                mb_loss, grads = grads_of(leaves, params, mb)
                loss = loss + mb_loss
                for a, g in zip(acc, grads):
                    a.add_(g.float())
                del grads
            loss = loss / microbatches
            for a in acc:
                a.div_(microbatches)
        else:
            loss, grads = grads_of(leaves, params, batch)
            acc = [g.float() for g in grads]
            del grads
        params, opt_state, stats = opt_update(params, acc, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **stats}

    return train_step


def make_eval_step(model: LM) -> Callable:
    """Returns eval_step(params, batch) -> the loss, without autograd."""
    def eval_step(params, batch):
        with torch.no_grad():
            return model.loss(params, batch)
    return eval_step

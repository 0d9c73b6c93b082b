"""train_step / eval_step factories.

Gradients come from autograd over the parameter leaves (the loss is
rematerialized layer by layer, see ``models.lm``); with microbatches they
accumulate in f32 and the loss and gradients are divided by the count, as
the reference's ``lax.scan`` over microbatches does.  The optimizer then
updates params and moments in place.  Metrics stay 0-d device tensors, so
a step never synchronises with the host.

``shard_train_step`` is the counterpart of the reference's
``jit_train_step``: params and optimizer state become DTensors placed by
the sanitized specs, the batch is sharded by ``("batch", "seq")``, and the
step runs on them, each op as DTensor's propagation dictates (gradients
come back as partial sums, which the optimizer redistributes to the
params' placements).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.lm import LM
from repro_torch.sharding.specs import (AxisRules, logical_spec, placements,
                                        sanitize_tree)
from repro_torch.train.optimizer import (OptConfig, map_tree, opt_specs,
                                         opt_update, tree_leaves)


def _split_microbatches(batch: dict, k: int) -> list[dict]:
    """``k`` microbatches of contiguous rows, as the reference splits them.
    A batch-sharded DTensor is split on each rank's own rows (microbatch i
    is every rank's i-th chunk), so a microbatch stays sharded;
    ``shard_train_step`` lays a batch out so that these are the reference's
    microbatches."""
    from torch.distributed.tensor import DTensor

    def split(x, i):
        if isinstance(x, DTensor):
            part = split(x.to_local(), i)
            return DTensor.from_local(part, x.device_mesh, x.placements,
                                      run_check=False)
        return x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]

    return [{key: split(x, i) for key, x in batch.items()} for i in range(k)]


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
            loss, acc = None, None
            for mb in _split_microbatches(batch, microbatches):
                mb_loss, grads = grads_of(leaves, params, mb)
                if acc is None:   # 0 + g: the first microbatch's, exactly
                    loss, acc = mb_loss, [g.float() for g in grads]
                else:
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

    train_step.microbatches = microbatches
    return train_step


def make_eval_step(model: LM) -> Callable:
    """Returns eval_step(params, batch) -> the loss, without autograd."""
    def eval_step(params, batch):
        with torch.no_grad():
            return model.loss(params, batch)
    return eval_step


def distribute_tree(tree, spec_tree, mesh):
    """Every leaf as a DTensor on ``mesh`` placed by its spec: a plain
    tensor is distributed (each rank passes the same full tensor), a
    DTensor redistributed where its placements differ."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(t, spec):
        want = placements(spec, mesh)
        if isinstance(t, DTensor):
            return t if list(t.placements) == want else \
                t.redistribute(mesh, want)
        return distribute_tensor(t, mesh, want)

    if isinstance(tree, dict):
        return {k: distribute_tree(v, spec_tree[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, s, mesh)
                          for v, s in zip(tree, spec_tree))
    return place(tree, spec_tree)


def sharded_specs(model: LM, mesh, rules: AxisRules | None = None
                  ) -> tuple[dict, dict]:
    """(param specs, optimizer-state specs), sanitized against the
    params' shapes on ``mesh``."""
    pspecs = sanitize_tree(model.param_specs(rules, mesh),
                           model.abstract_params(), mesh)
    return pspecs, opt_specs(pspecs)


def shard_train_step(model: LM, train_step: Callable, mesh,
                     rules: AxisRules | None = None):
    """The counterpart of the reference's ``jit_train_step``: returns
    (step, data placements).  ``step(params, opt_state, batch)`` places
    params and optimizer state by the sanitized specs (leaves already so
    placed are used as they are, and updated in place), shards every batch
    tensor by ``logical_spec(("batch", "seq"))`` (each rank passes the
    same full batch, or DTensors so placed), and runs ``train_step`` on
    the DTensors with plain constants taken as replicated.  The loss comes
    back as a plain 0-d tensor, the same on every rank.

    With ``train_step.microbatches`` = k > 1, a full batch is laid out so
    that each rank's rows are, in order, its shard of each of the
    reference's k microbatches (rows i*B/k to (i+1)*B/k): the step's split
    of each rank's own rows then gives the reference's microbatches, still
    sharded."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    pspecs, ospecs = sharded_specs(model, mesh, rules)
    data_pl = placements(logical_spec(("batch", "seq"), rules, mesh), mesh)
    k = getattr(train_step, "microbatches", 1)
    stacked_pl = [Shard(p.dim + 1) if p.is_shard() else p for p in data_pl]

    def place(v: torch.Tensor):
        if isinstance(v, DTensor):
            return v
        if k == 1:
            return distribute_tensor(v, mesh, data_pl)
        mbs = v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))
        local = distribute_tensor(mbs, mesh, stacked_pl).to_local()
        return DTensor.from_local(local.flatten(0, 1), mesh, data_pl,
                                  run_check=False)

    def step(params, opt_state, batch):
        params = distribute_tree(params, pspecs, mesh)
        opt_state = distribute_tree(opt_state, ospecs, mesh)
        batch = {key: place(v) for key, v in batch.items()}
        with implicit_replication():
            params, opt_state, metrics = train_step(params, opt_state, batch)
        return params, opt_state, map_tree(
            lambda m: m.full_tensor() if isinstance(m, DTensor) else m,
            metrics)

    return step, data_pl

"""Mixture-of-Experts FFN with top-k routing and capacity-bounded dispatch.

Dispatch is scatter-based, as in the reference: tokens are grouped by the
batch dim, each group scatter-adds its tokens into per-expert capacity
buffers (B, E, cap, d), experts run batched GEMMs over (group, expert), and
a gather + weighted sum combines the results.  Capacity-dropped tokens fall
through the residual (Switch-style).  `impl="fused"` routes through the
router kernel (`kernels.ops.moe_router`); `impl="xla"` computes the logits
and `router_topk` in plain torch.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec, activation_fn
from repro_torch.sharding.specs import AxisRules, with_logical_constraint

NEG_INF = -1e30


def moe_schema(cfg: ModelConfig) -> dict:
    d, E, Ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    dt = cfg.dtype
    return {
        "router": ParamSpec((d, E), ("embed", "experts"), torch.float32,
                            scale=0.1),
        "w_gate": ParamSpec((E, d, Ff), ("experts", "embed", "ffn"), dt),
        "w_up": ParamSpec((E, d, Ff), ("experts", "embed", "ffn"), dt),
        "w_down": ParamSpec((E, Ff, d), ("experts", "ffn", "embed"), dt),
    }


def router_logits(p: dict, x: torch.Tensor, rules: AxisRules | None = None
                  ) -> torch.Tensor:
    """x (B, L, d) -> f32 router logits (B, L, E), split by batch alone
    (top-k and the aux loss index along the experts and flatten B, L)."""
    return with_logical_constraint(x.float() @ p["router"],
                                   ("batch", "seq", None), rules)


def router_topk(logits: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., E) -> (weights (..., k), indices (..., k)); softmax over the k.

    Ties go to the lowest expert index, as ``lax.top_k`` breaks them: k
    passes of ``argmax`` (which returns the first maximum), each masking the
    entry it took (``torch.topk`` promises no order among ties)."""
    work = logits
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(work, dim=-1, keepdim=True)
        vals.append(torch.gather(logits, -1, i))
        idxs.append(i)
        work = work.scatter(-1, i, NEG_INF)
    w = torch.softmax(torch.cat(vals, dim=-1).float(), dim=-1)
    return w, torch.cat(idxs, dim=-1)


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    E, k = cfg.num_experts, cfg.experts_per_token
    cap = max(int(cfg.capacity_factor * tokens_per_group * k / E), k)
    if cap >= 128:  # the reference's rounding once buffers are big enough
        cap = (cap + 127) // 128 * 128
    return min(cap, tokens_per_group * k)


def _expert_matmul(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("beck,ekn->becn") as one batched matmul over the experts:
    (B, E, cap, K) x (E, K, N) -> (B, E, cap, N), weights used in place."""
    B, E, C, K = buf.shape
    out = torch.bmm(buf.transpose(0, 1).reshape(E, B * C, K), w)
    return out.reshape(E, B, C, -1).transpose(0, 1)


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
              impl: str = "fused", *, rules: AxisRules | None = None
              ) -> torch.Tensor:
    """x: (B, L, d) -> (B, L, d).  B is the dispatch group dim."""
    B, L, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    cap = _capacity(cfg, L)

    if impl == "fused":
        weights, experts = ops.moe_router(x.reshape(B * L, d).contiguous(),
                                          p["router"], k)
        weights = weights.reshape(B, L, k)
        experts = experts.reshape(B, L, k).long()
    else:
        logits = router_logits(p, x, rules)                   # (B, L, E)
        weights, experts = router_topk(logits, k)             # (B, L, k)

    # position of each (token, choice) in its expert's buffer, per group
    flat_e = experts.reshape(B, L * k)                        # choice-major per token
    onehot = F.one_hot(flat_e, E).to(torch.int32)             # (B, L*k, E)
    pos_all = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = torch.gather(pos_all, -1, flat_e[..., None])[..., 0].long()
    pos = pos.reshape(B, L, k)
    keep = pos < cap
    weights = weights * keep.to(weights.dtype)
    pos = torch.where(keep, pos, cap - 1)  # clamp; dropped tokens masked anyway

    act = activation_fn(cfg.activation)
    args = (x, weights, experts, pos, keep, p["w_gate"], p["w_up"], p["w_down"])
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    if not isinstance(x, DTensor):
        return _experts_ffn(act, cap, None, *args).to(x.dtype)
    # experts sharded over a mesh axis: each rank dispatches its tokens
    # (whole on that axis) to its own experts only, and the ranks' partial
    # outputs are summed (expert parallelism; the reference leaves this to
    # its compiler)
    mesh = x.device_mesh
    w_pl = list(p["w_gate"].placements)
    ax = next((i for i, pl in enumerate(w_pl) if pl.is_shard(0)), None)
    e0 = None if ax is None else mesh.get_local_rank(ax) * (E // mesh.size(ax))
    act_pl = [Replicate() if i == ax else pl for i, pl in enumerate(x.placements)]
    out_pl = [Partial() if i == ax else pl for i, pl in enumerate(act_pl)]
    # a rank's tokens meet its experts whole: weights split over an axis
    # that splits the tokens (the ffn dim over data, say) are gathered there
    w_pl = [Replicate() if act_pl[i].is_shard() else pl
            for i, pl in enumerate(w_pl)]
    # x and the routing weights reach only this rank's experts, and the
    # expert weights see only this rank's tokens: their gradients are
    # partial sums, over the experts' axis and the token-split axes
    w_grad = [Partial() if not pl.is_shard() and act_pl[i].is_shard() else pl
              for i, pl in enumerate(w_pl)]
    out = local_map(functools.partial(_experts_ffn, act, cap, e0),
                    out_placements=out_pl,
                    in_placements=(act_pl,) * 5 + (w_pl,) * 3,
                    in_grad_placements=(out_pl,) * 2 + (act_pl,) * 3
                    + (w_grad,) * 3,
                    device_mesh=mesh, redistribute_inputs=True)(*args)
    out = with_logical_constraint(out, ("batch", "seq", "embed_act"), rules)
    return out.to(x.dtype)


def _experts_ffn(act, cap: int, e0: int | None, x, weights, experts, pos,
                 keep, w_gate, w_up, w_down) -> torch.Tensor:
    """Dispatch, expert FFN and weighted combine: f32 (B, L, d).  With
    ``e0`` (experts sharded) ``w_*`` hold experts [e0, e0 + E') and the
    result is those experts' share only."""
    B, L, d = x.shape
    k = experts.shape[-1]
    El = w_gate.shape[0]
    if e0 is not None:
        mine = (experts >= e0) & (experts < e0 + El)
        keep = keep & mine
        weights = weights * mine.to(weights.dtype)
        experts = torch.where(mine, experts - e0, 0)

    # scatter-add tokens into expert buffers, one scatter per routing choice
    buf = x.new_zeros((B, El, cap, d))
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, L)
    for j in range(k):
        contrib = x * keep[:, :, j, None].to(x.dtype)
        buf.index_put_((b_idx, experts[:, :, j], pos[:, :, j]), contrib,
                       accumulate=True)

    # expert FFN: batched over (group, expert)
    hidden = act(_expert_matmul(buf, w_gate)) * _expert_matmul(buf, w_up)
    out_buf = _expert_matmul(hidden, w_down)

    # gather back + weighted combine
    out = torch.zeros((B, L, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        gathered = out_buf[b_idx, experts[:, :, j], pos[:, :, j]]   # (B, L, d)
        out = out + gathered.float() * weights[:, :, j, None]
    return out


def moe_aux_loss(router_logits: torch.Tensor, experts: torch.Tensor,
                 E: int) -> torch.Tensor:
    """Switch-style load-balancing loss (mean prob x mean top-1 assignment)."""
    probs = torch.softmax(router_logits.float(), dim=-1).reshape(-1, E)
    top1 = experts.reshape(-1, experts.shape[-1])[:, 0]
    me = probs.mean(dim=0)
    ce = F.one_hot(top1.long(), E).float().mean(dim=0)
    return E * torch.sum(me * ce)

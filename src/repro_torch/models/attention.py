"""GQA attention with RoPE, causal / sliding-window masks, cross-attention,
and KV-cache support.  `impl="flash"` sends causal self-attention through
the flash-attention kernel (`kernels.ops.flash_attention`); `impl="xla"`
keeps the reference's einsum path in plain torch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec, apply_rope
from repro_torch.sharding.specs import (AxisRules, logical_placements,
                                        per_shard, splittable,
                                        with_logical_constraint)

NEG_INF = -1e30


def attn_schema(cfg: ModelConfig, cross: bool = False) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    dt = cfg.dtype
    sch = {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", "head_dim"), dt),
        "wk": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim"), dt),
        "wv": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim"), dt),
        "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed"), dt),
    }
    if cfg.qkv_bias:
        sch["bq"] = ParamSpec((H, hd), ("heads", "head_dim"), dt, "zeros")
        sch["bk"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), dt, "zeros")
        sch["bv"] = ParamSpec((KV, hd), ("kv_heads", "head_dim"), dt, "zeros")
    return sch


def _proj(x: torch.Tensor, w: torch.Tensor,
          rules: AxisRules | None = None) -> torch.Tensor:
    """einsum("bld,dhk->bhlk"): (B, L, d) x (d, H, k) -> (B, H, L, k)."""
    B, L, _ = x.shape
    _, H, k = w.shape
    # constrained as (B, L, H, k): a (B, L, H * k) constraint would split
    # the replicated k / v of KV heads that do not tile the model axis, for
    # the head split to gather them back
    y = splittable(x @ w.reshape(w.shape[0], H * k), -1, H).reshape(B, L, H, k)
    y = with_logical_constraint(y, ("batch", "seq", "heads", "head_dim"), rules)
    return y.transpose(1, 2)


def _out_proj(o: torch.Tensor, wo: torch.Tensor,
              rules: AxisRules | None = None) -> torch.Tensor:
    """einsum("bhlk,hkd->bld"): (B, H, L, k) x (H, k, d) -> (B, L, d).
    ``o`` is held to heads-sharding first, so that (H, k) can merge."""
    B, H, L, k = o.shape
    o = with_logical_constraint(o, ("batch", "heads", "seq", "head_dim"), rules)
    return o.transpose(1, 2).reshape(B, L, H * k) @ wo.reshape(H * k, -1)


def _project_qkv(p: dict, x: torch.Tensor, x_kv: torch.Tensor,
                 rules: AxisRules | None = None):
    q = _proj(x, p["wq"], rules)
    k = _proj(x_kv, p["wk"], rules)
    v = _proj(x_kv, p["wv"], rules)
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    q = with_logical_constraint(q, ("batch", "heads", "seq", "head_dim"), rules)
    return q, k, v


# the attention core runs per (batch, head) shard: seq and head_dim whole
_HEADS = ("batch", "heads", None, None)


def _sdpa_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor | None,
               rules: AxisRules | None = None) -> torch.Tensor:
    """Full-sequence attention. q: (B,H,Lq,hd); k,v: (B,KV,Lk,hd).  KV heads
    are repeated to H, as the reference does."""
    H = q.shape[1]
    KV = k.shape[1]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    k = with_logical_constraint(k, ("batch", "heads", "seq", "head_dim"), rules)
    v = with_logical_constraint(v, ("batch", "heads", "seq", "head_dim"), rules)
    return per_shard(_attend, (q, k, v, mask), (_HEADS, _HEADS, _HEADS, None),
                     (_HEADS, q.shape), rules)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor | None) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[3])
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return (probs @ v.float()).to(v.dtype)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int, block_q: int = 512,
                  rules: AxisRules | None = None) -> torch.Tensor:
    """Chunked attention on the xla path: a loop over q blocks, so only a
    (B,H,bq,Lk) score slab is ever live.  Numerically identical to
    _sdpa_full (per-row softmax over the full kv extent of each block)."""
    H = q.shape[1]
    KV = k.shape[1]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    k = with_logical_constraint(k, ("batch", "heads", "seq", "head_dim"), rules)
    v = with_logical_constraint(v, ("batch", "heads", "seq", "head_dim"), rules)

    def attend(q, k, v):
        L, hd = q.shape[2], q.shape[3]
        bq = min(block_q, L)
        assert L % bq == 0
        scale = 1.0 / math.sqrt(hd)
        kf, vf = k.float(), v.float()
        kpos = torch.arange(k.shape[2], device=q.device)
        blocks = []
        for q0 in range(0, L, bq):
            s = (q[:, :, q0:q0 + bq].float() @ kf.transpose(-1, -2)) * scale
            qpos = q0 + torch.arange(bq, device=q.device)
            m = torch.ones((bq, k.shape[2]), dtype=torch.bool, device=q.device)
            if causal:
                m &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                m &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(m, s, torch.full_like(s, NEG_INF))
            blocks.append((torch.softmax(s, dim=-1) @ vf).to(v.dtype))
        return torch.cat(blocks, dim=2)

    return per_shard(attend, (q, k, v), (_HEADS, _HEADS, _HEADS),
                     (_HEADS, q.shape), rules)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None,
          rules: AxisRules | None = None) -> torch.Tensor:
    """Grouped GQA attention (decode path: Lq=1, scores stay small).
    q: (B,H,Lq,hd); k,v: (B,KV,Lk,hd); mask broadcastable to (B,KV,G,Lq,Lk).

    On a mesh the core runs per (batch, KV head) shard, as the prefill
    cores run per (batch, head) shard: q's heads split with the KV heads
    they attend to, or stay whole with them.  A cache split along its
    length (``kv_seq``, where the KV heads do not tile the model axis) is
    left to DTensor, which reduces the scores over the split."""
    from torch.distributed.tensor import DTensor
    if isinstance(k, DTensor):
        if any(pl.is_shard(2) for pl in k.placements):
            return _grouped(q, k, v, mask)
        lg = ("batch", "kv_heads", None, None)
        if not any(pl.is_shard(1) for pl in logical_placements(
                lg, k.shape, k.device_mesh, rules)):
            lg = ("batch", None, None, None)
        return per_shard(_grouped, (q, k, v, mask), (lg, lg, lg, None),
                         (lg, q.shape), rules)
    return _grouped(q, k, v, mask)


def _grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: torch.Tensor | None) -> torch.Tensor:
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    G = H // KV
    # batched over (B, KV) as explicit bmm's: the same products the 4-D
    # matmul makes, without its expand, which DTensor cannot shard here
    qg = splittable(q, 1, KV).reshape(B * KV, G * Lq, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.bmm(qg.float(),
                       k.reshape(B * KV, Lk, hd).float().transpose(1, 2))
    logits = (logits * scale).reshape(B, KV, G, Lq, Lk)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).reshape(B * KV, G * Lq, Lk)
    out = torch.bmm(probs, v.reshape(B * KV, Lk, hd).float())
    return out.reshape(B, H, Lq, hd).to(v.dtype)


def causal_mask(Lq: int, Lk: int, window: int = 0, offset: int = 0,
                device: torch.device | None = None) -> torch.Tensor:
    """(1,1,1,Lq,Lk) boolean; offset = absolute position of query 0."""
    qpos = torch.arange(Lq, device=device)[:, None] + offset
    kpos = torch.arange(Lk, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m[None, None, None]


def attention(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor | None = None,
    causal: bool = True,
    window: int = 0,
    x_kv: torch.Tensor | None = None,    # cross-attention source
    use_rope: bool = True,
    impl: str = "flash",
    return_kv: bool = False,
    rules: AxisRules | None = None,
):
    """Full-sequence attention (prefill). x: (B, L, d)."""
    B, L, _ = x.shape
    self_attn = x_kv is None
    x_kv = x if self_attn else x_kv
    q, k, v = _project_qkv(p, x, x_kv, rules)
    if use_rope and self_attn:
        pos = positions if positions is not None else torch.arange(L, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta, cfg.rope_pct)
        k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_pct)
    if impl == "flash" and causal and self_attn:
        out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True, window=window)
    elif self_attn and (impl == "xla_chunked"
                        or (impl == "xla" and L >= 8192 and L % 512 == 0)):
        # long sequences: chunked q-block attention (see _sdpa_chunked)
        out = _sdpa_chunked(q, k, v, causal=causal, window=window,
                            rules=rules)
    else:
        mask = (causal_mask(L, k.shape[2], window, device=x.device)[:, :, 0]
                if (causal and self_attn) else None)
        out = _sdpa_full(q, k, v, mask, rules)
    out = with_logical_constraint(_out_proj(out, p["wo"], rules),
                                  ("batch", "seq", "embed_act"), rules)
    if return_kv:
        return out, (k, v)
    return out


def cross_decode(p: dict, x: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                 cfg: ModelConfig, rules: AxisRules | None = None
                 ) -> torch.Tensor:
    """Decode-time cross-attention over a precomputed (frames) KV cache."""
    q = _proj(x, p["wq"], rules)
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
    out = _sdpa(q, xk, xv, None, rules)
    return with_logical_constraint(_out_proj(out, p["wo"], rules),
                                   ("batch", "seq", "embed_act"), rules)


# ------------------------------------------------------------ decode (cached) ---


def _write_slot(cache: torch.Tensor, slot: int, new: torch.Tensor) -> None:
    """``cache[:, :, slot] = new`` in place (``index_copy_``).  On a mesh
    each rank writes into its own shard, where the slot lies in it:
    DTensor's ``index_copy_`` along a split dim writes into a
    redistributed copy and relabels the cache's placements."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(cache, DTensor):
        cache.index_copy_(2, torch.tensor([slot], device=cache.device),
                          new.to(cache.dtype))
        return
    mesh, pl = cache.device_mesh, cache.placements
    local = cache.to_local()
    new = new.to(cache.dtype).redistribute(
        mesh, [Replicate() if p.is_shard(2) else p for p in pl]).to_local()
    # this rank's first slot: the length split as torch.chunk splits it,
    # over the mesh dims in order (as DTensor's Shard does)
    first, size = 0, cache.shape[2]
    for i, p in enumerate(pl):
        if p.is_shard(2):
            step = -(-size // mesh.size(i))
            first += min(mesh.get_local_rank(i) * step, size)
            size = min(step, size - min(mesh.get_local_rank(i) * step, size))
    at = slot - first
    if 0 <= at < local.shape[2]:
        local.index_copy_(2, torch.tensor([at], device=local.device), new)


def decode_attention(
    p: dict,
    x: torch.Tensor,                # (B, 1, d)
    cache_k: torch.Tensor,          # (B, KV, S, hd)
    cache_v: torch.Tensor,
    cache_len: int,                 # tokens already in cache
    cfg: ModelConfig,
    *,
    window: int = 0,
    use_rope: bool = True,
    rules: AxisRules | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode: returns (out (B,1,d), cache_k, cache_v).

    Unlike the reference, which returns new cache arrays, the new token's
    key and value are written into ``cache_k``/``cache_v`` in place
    (``_write_slot``), and the same tensors are returned."""
    S = cache_k.shape[2]
    q, k, v = _project_qkv(p, x, x, rules)
    if use_rope:
        pos = torch.tensor([cache_len], device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta, cfg.rope_pct)
        k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_pct)
    # ring-buffer write for SWA, append otherwise
    slot = cache_len % S if window > 0 else min(cache_len, S - 1)
    _write_slot(cache_k, slot, k)
    _write_slot(cache_v, slot, v)
    kpos = torch.arange(S, device=x.device)
    if window > 0:
        valid = kpos < min(cache_len + 1, S)
    else:
        valid = kpos <= min(cache_len, S - 1)
    out = _sdpa(q, cache_k, cache_v, valid[None, None, None, None, :],
                rules)
    return (with_logical_constraint(_out_proj(out, p["wo"], rules),
                                    ("batch", "seq", "embed_act"), rules),
            cache_k, cache_v)

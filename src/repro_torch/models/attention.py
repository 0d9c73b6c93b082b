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


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bld,dhk->bhlk"): (B, L, d) x (d, H, k) -> (B, H, L, k)."""
    B, L, _ = x.shape
    _, H, k = w.shape
    return (x @ w.reshape(w.shape[0], H * k)).reshape(B, L, H, k).transpose(1, 2)


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bhlk,hkd->bld"): (B, H, L, k) x (H, k, d) -> (B, L, d)."""
    B, H, L, k = o.shape
    return o.transpose(1, 2).reshape(B, L, H * k) @ wo.reshape(H * k, -1)


def _project_qkv(p: dict, x: torch.Tensor, x_kv: torch.Tensor):
    q = _proj(x, p["wq"])
    k = _proj(x_kv, p["wk"])
    v = _proj(x_kv, p["wv"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    return q, k, v


def _sdpa_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor | None) -> torch.Tensor:
    """Full-sequence attention. q: (B,H,Lq,hd); k,v: (B,KV,Lk,hd).  KV heads
    are repeated to H, as the reference does."""
    H, hd = q.shape[1], q.shape[3]
    KV = k.shape[1]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    scale = 1.0 / math.sqrt(hd)
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return (probs @ v.float()).to(v.dtype)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int, block_q: int = 512) -> torch.Tensor:
    """Chunked attention on the xla path: a loop over q blocks, so only a
    (B,H,bq,Lk) score slab is ever live.  Numerically identical to
    _sdpa_full (per-row softmax over the full kv extent of each block)."""
    B, H, L, hd = q.shape
    KV = k.shape[1]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
    block_q = min(block_q, L)
    assert L % block_q == 0
    scale = 1.0 / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(k.shape[2], device=q.device)
    blocks = []
    for q0 in range(0, L, block_q):
        s = (q[:, :, q0:q0 + block_q].float() @ kf.transpose(-1, -2)) * scale
        qpos = q0 + torch.arange(block_q, device=q.device)
        m = torch.ones((block_q, k.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            m &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            m &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(m, s, torch.full_like(s, NEG_INF))
        blocks.append((torch.softmax(s, dim=-1) @ vf).to(v.dtype))
    return torch.cat(blocks, dim=2)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None) -> torch.Tensor:
    """Grouped GQA attention (decode path: Lq=1, scores stay small).
    q: (B,H,Lq,hd); k,v: (B,KV,Lk,hd); mask broadcastable to (B,KV,G,Lq,Lk)."""
    B, H, Lq, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G * Lq, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = (qg.float() @ k.float().transpose(-1, -2)) * scale
    logits = logits.reshape(B, KV, G, Lq, -1)
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).reshape(B, KV, G * Lq, -1)
    out = probs @ v.float()
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
):
    """Full-sequence attention (prefill). x: (B, L, d)."""
    B, L, _ = x.shape
    self_attn = x_kv is None
    x_kv = x if self_attn else x_kv
    q, k, v = _project_qkv(p, x, x_kv)
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
        out = _sdpa_chunked(q, k, v, causal=causal, window=window)
    else:
        mask = (causal_mask(L, k.shape[2], window, device=x.device)[:, :, 0]
                if (causal and self_attn) else None)
        out = _sdpa_full(q, k, v, mask)
    out = _out_proj(out, p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def cross_decode(p: dict, x: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Decode-time cross-attention over a precomputed (frames) KV cache."""
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
    out = _sdpa(q, xk, xv, None)
    return _out_proj(out, p["wo"])


# ------------------------------------------------------------ decode (cached) ---


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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode: returns (out (B,1,d), cache_k, cache_v).

    Unlike the reference, which returns new cache arrays, the new token's
    key and value are written into ``cache_k``/``cache_v`` in place
    (``index_copy_``), and the same tensors are returned."""
    S = cache_k.shape[2]
    q, k, v = _project_qkv(p, x, x)
    if use_rope:
        pos = torch.tensor([cache_len], device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta, cfg.rope_pct)
        k = apply_rope(k, pos, cfg.rope_theta, cfg.rope_pct)
    # ring-buffer write for SWA, append otherwise
    slot = cache_len % S if window > 0 else min(cache_len, S - 1)
    at = torch.tensor([slot], device=x.device)
    cache_k.index_copy_(2, at, k.to(cache_k.dtype))
    cache_v.index_copy_(2, at, v.to(cache_v.dtype))
    kpos = torch.arange(S, device=x.device)
    if window > 0:
        valid = kpos < min(cache_len + 1, S)
    else:
        valid = kpos <= min(cache_len, S - 1)
    out = _sdpa(q, cache_k, cache_v, valid[None, None, None, None, :])
    return _out_proj(out, p["wo"]), cache_k, cache_v

"""Parameter schema machinery + elementary layers (norms, RoPE, MLP, embeds).

Params are plain nested dicts (and per-layer lists) of tensors.  Every leaf
is declared once as a `ParamSpec(shape, logical, ...)`; from the schema we
derive random inits and parameter counts.  `logical` names each axis as the
reference's sharding rules do; nothing is sharded yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    dtype: Any = torch.bfloat16
    init: str = "normal"      # normal | zeros | ones
    scale: float = 1.0        # stddev multiplier (normal: 1/sqrt(fan_in) base)

    def __post_init__(self) -> None:
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def map_schema(fn: Callable[[ParamSpec], Any], schema) -> Any:
    """Apply ``fn`` to every ``ParamSpec`` of a nested dict/list schema, in
    a fixed order (dict keys sorted, lists in order), keeping the nesting."""
    if isinstance(schema, ParamSpec):
        return fn(schema)
    if isinstance(schema, dict):
        return {k: map_schema(fn, schema[k]) for k in sorted(schema)}
    return [map_schema(fn, s) for s in schema]


def init_from_schema(generator: torch.Generator, schema,
                     device: torch.device) -> Any:
    """Random tensors for every leaf, drawn from ``generator`` (which lives
    on ``device``) with the reference's rule: normal leaves get std
    ``scale / sqrt(fan_in)``, fan_in being the second-to-last dim (the last
    one for 1-D leaves)."""
    def init_one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else max(s.shape[-1], 1)
        std = s.scale / math.sqrt(max(fan_in, 1))
        w = torch.randn(s.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * std).to(s.dtype)

    return map_schema(init_one, schema)


def stack_schema(schema, n: int) -> Any:
    """Prepend a stacked-layers dim: the reference's layout of ``n`` layers
    of ``schema`` (the port keeps one entry per layer instead)."""
    return map_schema(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.logical, s.dtype,
                            s.init, s.scale), schema)


def param_count(schema) -> int:
    total = [0]

    def add(s: ParamSpec) -> None:
        total[0] += math.prod(s.shape)

    map_schema(add, schema)
    return total[0]


# ------------------------------------------------------------------- layers -----


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def norm_schema(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamSpec((d,), (None,), torch.float32, "ones")}
    return {"scale": ParamSpec((d,), (None,), torch.float32, "ones"),
            "bias": ParamSpec((d,), (None,), torch.float32, "zeros")}


def apply_norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu2":  # squared ReLU (nemotron-4)
        return _relu2
    raise ValueError(name)


# --- RoPE -------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, rope_pct: float = 1.0,
               device: torch.device | None = None) -> torch.Tensor:
    rot = int(head_dim * rope_pct) // 2 * 2
    exponents = torch.arange(0, rot, 2, dtype=torch.float32,
                             device=device) / max(rot, 1)
    return 1.0 / (theta ** exponents)            # (rot/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_pct: float = 1.0) -> torch.Tensor:
    """x: (..., seq, head_dim); positions: broadcastable to (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, rope_pct, x.device)
    rot = freqs.shape[0] * 2
    angles = positions[..., None].float() * freqs   # (..., seq, rot/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(*x.shape[:-1], rot)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


# --- MLP ----------------------------------------------------------------------


def mlp_schema(d_model: int, d_ff: int, activation: str, dtype) -> dict:
    gated = activation in ("silu", "gelu")
    sch = {
        "w_up": ParamSpec((d_model, d_ff), ("embed", "ffn"), dtype),
        "w_down": ParamSpec((d_ff, d_model), ("ffn", "embed"), dtype),
    }
    if gated:
        sch["w_gate"] = ParamSpec((d_model, d_ff), ("embed", "ffn"), dtype)
    return sch


def mlp_apply(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    act = activation_fn(activation)
    up = x @ p["w_up"]
    if "w_gate" in p:
        up = up * act(x @ p["w_gate"])
    else:
        up = act(up)
    return up @ p["w_down"]


# --- Embedding ------------------------------------------------------------------


def embed_schema(vocab: int, d_model: int, dtype) -> dict:
    return {"table": ParamSpec((vocab, d_model), ("vocab", "embed_table"),
                               dtype, scale=1.0)}


def embed_apply(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def unembed_apply(table: torch.Tensor, h: torch.Tensor,
                  real_vocab: int | None = None) -> torch.Tensor:
    """h: (..., d); table: (padded_vocab, d) -> logits in fp32; columns past
    `real_vocab` are masked to -1e30 (vocab padding, see configs.base)."""
    logits = h.float() @ table.float().T
    V = table.shape[0]
    if real_vocab is not None and real_vocab < V:
        logits[..., real_vocab:] = -1e30
    return logits

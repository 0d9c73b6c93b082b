"""Parameter schema machinery + elementary layers (norms, RoPE, MLP, embeds).

Params are plain nested dicts (and per-layer lists) of tensors.  Every leaf
is declared once as a `ParamSpec(shape, logical, ...)`; from the schema we
derive random inits, abstract tensors on the ``meta`` device (the dry
run), parameter counts, and sharding specs: `logical` names each axis as
the reference's sharding rules do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.sharding.specs import (AxisRules, logical_spec,
                                        with_logical_constraint)


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
                     device: torch.device,
                     place: Callable[[torch.Tensor, ParamSpec], Any] | None
                     = None) -> Any:
    """Random tensors for every leaf, drawn from ``generator`` (which lives
    on ``device``) with the reference's rule: normal leaves get std
    ``scale / sqrt(fan_in)``, fan_in being the second-to-last dim (the last
    one for 1-D leaves).  ``place(leaf, spec)``, where given, gets each leaf
    as soon as it is drawn and its result is kept instead, so the full
    leaves need never be live together."""
    def init_one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else max(s.shape[-1], 1)
        std = s.scale / math.sqrt(max(fan_in, 1))
        w = torch.randn(s.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(std).to(s.dtype)

    if place is None:
        return map_schema(init_one, schema)
    return map_schema(lambda s: place(init_one(s), s), schema)


def abstract_from_schema(schema) -> Any:
    """Tensors of every leaf's shape and dtype on the ``meta`` device: no
    storage, the counterpart of the reference's ShapeDtypeStructs."""
    return map_schema(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), schema)


def specs_from_schema(schema, rules: AxisRules | None = None, mesh=None) -> Any:
    return map_schema(lambda s: logical_spec(s.logical, rules, mesh), schema)


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


def mlp_apply(p: dict, x: torch.Tensor, activation: str,
              rules: AxisRules | None = None) -> torch.Tensor:
    """The (gated) MLP.  On DTensors the hidden activations are held to
    ("batch", "seq", "ffn"), so that rows stay split by batch alone."""
    act = activation_fn(activation)
    hidden = ("batch", "seq", "ffn")
    up = with_logical_constraint(x @ p["w_up"], hidden, rules)
    if "w_gate" in p:
        up = up * act(with_logical_constraint(x @ p["w_gate"], hidden, rules))
    else:
        up = act(up)
    return with_logical_constraint(up @ p["w_down"],
                                   ("batch", "seq", "embed_act"), rules)


# --- Embedding ------------------------------------------------------------------


def embed_schema(vocab: int, d_model: int, dtype) -> dict:
    return {"table": ParamSpec((vocab, d_model), ("vocab", "embed_table"),
                               dtype, scale=1.0)}


def embed_apply(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    table = p["table"]
    from torch.distributed.tensor import DTensor
    if isinstance(table, DTensor):
        return _embed_vocab_parallel(table, tokens)
    return table[tokens.long()]


def _embed_vocab_parallel(table, tokens: torch.Tensor) -> torch.Tensor:
    """The lookup on a DTensor table whose vocab rows may be sharded: each
    rank looks its tokens up in its own rows (rows it does not hold read
    0) and the ranks' partial rows are summed, one of them non-zero, so the
    values and their gradients are the plain lookup's bit for bit.  (DTensor's
    own sharded lookup does not differentiate on every torch version.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    t_pl = [pl if pl.is_shard(0) else Replicate() for pl in table.placements]
    ax = next((i for i, pl in enumerate(t_pl) if pl.is_shard(0)), None)
    placed = isinstance(tokens, DTensor)   # plain tokens: the same on every rank
    tok_pl = [pl if placed and i != ax else Replicate()
              for i, pl in enumerate(tokens.placements if placed else t_pl)]
    out_pl = [Partial() if i == ax else pl for i, pl in enumerate(tok_pl)]
    # the table's gradient sums over the ranks that split the tokens
    grad_pl = [Partial() if not pl.is_shard() and tok_pl[i].is_shard() else pl
               for i, pl in enumerate(t_pl)]
    rows = table.shape[0] // (mesh.size(ax) if ax is not None else 1)
    e0 = None if ax is None else mesh.get_local_rank(ax) * rows

    def lookup(t, tok):
        if e0 is None:
            return t[tok.long()]
        tok = tok.long() - e0
        mine = (tok >= 0) & (tok < t.shape[0])
        return t[torch.where(mine, tok, 0)] * mine[..., None].to(t.dtype)

    return local_map(lookup, out_placements=out_pl,
                     in_placements=(t_pl, tok_pl if placed else None),
                     in_grad_placements=(grad_pl, tok_pl if placed else None),
                     device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def unembed_apply(table: torch.Tensor, h: torch.Tensor,
                  real_vocab: int | None = None) -> torch.Tensor:
    """h: (..., d); table: (padded_vocab, d) -> logits in fp32; columns past
    `real_vocab` are masked to -1e30 (vocab padding, see configs.base)."""
    logits = h.float() @ table.float().T
    V = table.shape[0]
    if real_vocab is not None and real_vocab < V:
        # a mask over the columns rather than a slice assignment, which a
        # vocab-sharded DTensor cannot take
        pad = torch.arange(V, device=logits.device) >= real_vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits

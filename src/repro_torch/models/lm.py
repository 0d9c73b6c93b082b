"""Model assembly for all assigned families.

- dense / moe / vlm : decoder-only transformer (GQA, optional SWA, MoE FFN)
- ssm               : Mamba2 stack (no FFN)
- hybrid            : Jamba superblocks (7 mamba + 1 attn per 8 layers,
                      MoE on odd layers)
- audio             : whisper-style encoder-decoder (frontends are stubs)

Parameters and caches hold one entry per layer (per superblock for the
hybrid family), and the layers run in a Python loop where the reference
scans over stacked layers.  Apply modes: `forward` (logits of every
position), `loss` (next-token cross-entropy + MoE aux, for training),
`prefill` (forward + cache out), `decode_step` (1 token, cache in/out).

Under autograd each layer is rematerialized (`torch.utils.checkpoint`,
non-reentrant), as the reference's `jax.checkpoint` does over its scan
body; `remat_policy="dots"` keeps matmul outputs
(`create_selective_checkpoint_contexts`), the counterpart of
`checkpoint_dots`.  The reference's `scan_unroll` is an accounting mode of
XLA's scan and has no meaning here, so it is left out.

Positional encoding is RoPE everywhere, as in the reference (which replaces
whisper's learned/sinusoidal embeddings by RoPE).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.core.agent import _resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (ParamSpec, abstract_from_schema,
                                       apply_norm, embed_apply, embed_schema,
                                       init_from_schema, map_schema,
                                       mlp_apply, mlp_schema, norm_schema,
                                       param_count, specs_from_schema,
                                       unembed_apply)
from repro_torch.sharding.specs import (PRODUCTION_TP, AxisRules,
                                        gather_fsdp, logical_spec, placements,
                                        sanitize_spec,
                                        with_logical_constraint)


@dataclasses.dataclass(frozen=True)
class ModelImpl:
    """Which path each kernel-backed op takes.  The default is the kernel
    path; the "xla" values are the reference's plain einsum paths, kept for
    parity tests, the on-card cross-check and training (no kernel has a
    backward).  ``remat``, ``remat_policy`` and ``loss_chunk`` act only
    where autograd records (``LM.loss`` under grad)."""
    attn: str = "flash"      # flash | xla | xla_chunked
    ssd: str = "kernel"      # kernel | xla
    moe: str = "fused"       # fused | xla
    remat: bool = True
    remat_policy: str = "full"   # full | dots | none
    loss_chunk: int = 0      # 0 = unchunked cross-entropy


# matmul outputs, which `remat_policy="dots"` keeps (jax's checkpoint_dots)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, impl: ModelImpl) -> Callable:
    """``fn`` rematerialized in the backward pass per ``impl``, where
    autograd records; ``fn`` itself otherwise."""
    if not impl.remat or impl.remat_policy == "none":
        return fn
    if impl.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {impl.remat_policy!r}")
    kw: dict[str, Any] = {"use_reentrant": False}
    if impl.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return checkpoint(fn, *args, **kwargs, **kw)

    return wrapped


def _pick_last(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``logits[..., idx]``: a gather, or on a DTensor (vocab sharded) a
    masked sum over the vocab, which keeps the logits sharded and adds
    only zeros to the picked entry, so the value and its gradient are the
    gather's bit for bit."""
    from torch.distributed.tensor import DTensor
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, idx[..., None])[..., 0]
    vocab = torch.arange(logits.shape[-1], device=idx.device)
    return torch.where(idx[..., None] == vocab, logits, 0.0).sum(-1)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp`` over the last (vocab) dim.  Of a DTensor whose
    vocab dim is split over ranks, as the row max plus the log of the
    summed exponentials: each reduces across the shards as one (B, L)
    all-reduce, where ``torch.logsumexp`` would gather every rank's logits
    in full (the (B, L, vocab) f32 logits, on every rank)."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(logits, DTensor) and any(
            p.is_shard(logits.ndim - 1) and n > 1
            for p, n in zip(logits.placements, logits.device_mesh.shape))):
        return torch.logsumexp(logits, dim=-1)
    from torch.distributed.tensor import Replicate

    def reduced(t):   # a partial max or sum over the shards, reduced now
        return t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])

    m = reduced(logits.detach().amax(dim=-1, keepdim=True))
    s = reduced(torch.exp(logits - m).sum(-1, keepdim=True))
    return (m + torch.log(s))[..., 0]


# ================================================================== blocks ======


class Block:
    """One transformer layer: mixer (attn | mamba | cross) + optional FFN."""

    def __init__(self, cfg: ModelConfig, impl: ModelImpl, *, mixer: str,
                 ffn: str, causal: bool = True, cross: bool = False,
                 rules: AxisRules | None = None):
        self.cfg, self.impl, self.rules = cfg, impl, rules
        self.mixer, self.ffn, self.causal, self.cross = mixer, ffn, causal, cross

    # ----------------------------------------------------------- schema -----
    def schema(self) -> dict:
        cfg = self.cfg
        sch: dict[str, Any] = {"norm1": norm_schema(cfg.d_model, cfg.norm)}
        if self.mixer == "attn":
            sch["attn"] = attn_mod.attn_schema(cfg)
        else:
            sch["mamba"] = mamba_mod.mamba_schema(cfg)
        if self.cross:
            sch["norm_x"] = norm_schema(cfg.d_model, cfg.norm)
            sch["cross"] = attn_mod.attn_schema(cfg)
        if self.ffn != "none":
            sch["norm2"] = norm_schema(cfg.d_model, cfg.norm)
            sch["ffn"] = (moe_mod.moe_schema(cfg) if self.ffn == "moe"
                          else mlp_schema(cfg.d_model, cfg.d_ff,
                                          cfg.activation, cfg.dtype))
        return sch

    def cache_schema(self, B: int, S: int) -> dict:
        cfg = self.cfg
        out: dict[str, Any] = {}
        if self.mixer == "attn":
            KV, hd = cfg.num_kv_heads, cfg.head_dim_
            Sw = min(S, cfg.window) if cfg.window > 0 else S
            # shard KV heads over `model` only when they tile it
            # (PRODUCTION_TP); otherwise the cache length (kv_seq) takes the
            # axis, so decode caches of GQA models still shard 512 ways
            kvh = "kv_heads" if KV % PRODUCTION_TP == 0 else None
            kv = ("batch", kvh, "kv_seq", "head_dim")
            out["k"] = ParamSpec((B, KV, Sw, hd), kv, cfg.dtype, "zeros")
            out["v"] = ParamSpec((B, KV, Sw, hd), kv, cfg.dtype, "zeros")
        else:
            dims = mamba_mod.mamba_dims(cfg)
            out["conv"] = ParamSpec((B, cfg.ssm_conv - 1, dims["conv_dim"]),
                                    ("batch", None, "ssm_inner"), cfg.dtype,
                                    "zeros")
            out["ssm"] = ParamSpec((B, dims["H"], dims["P"], dims["N"]),
                                   ("batch", "ssm_inner", None, "ssm_state"),
                                   torch.float32, "zeros")
        if self.cross:
            KV, hd = cfg.num_kv_heads, cfg.head_dim_
            kv = ("batch", "kv_heads", "frames", "head_dim")
            F = cfg.encoder_frames
            out["xk"] = ParamSpec((B, KV, F, hd), kv, cfg.dtype, "zeros")
            out["xv"] = ParamSpec((B, KV, F, hd), kv, cfg.dtype, "zeros")
        return out

    # ------------------------------------------------------------- apply ----
    def _ffn_apply(self, p: dict, h: torch.Tensor, with_aux: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """FFN sublayer.  The MoE load-balancing aux loss is computed only
        when ``with_aux`` (prefill and decode have no use for it)."""
        cfg, aux = self.cfg, None
        if self.ffn == "none":
            return h, aux
        hn = apply_norm(p["norm2"], h, cfg.norm)
        if self.ffn == "moe":
            if with_aux:
                logits = moe_mod.router_logits(p["ffn"], hn, self.rules)
                _, experts = moe_mod.router_topk(logits, cfg.experts_per_token)
                aux = moe_mod.moe_aux_loss(logits, experts, cfg.num_experts)
            out = moe_mod.moe_apply(p["ffn"], hn, cfg, self.impl.moe,
                                    rules=self.rules)
        else:
            out = mlp_apply(p["ffn"], hn, cfg.activation, self.rules)
        return h + out, aux

    def full(self, p: dict, h: torch.Tensor, *, enc: torch.Tensor | None = None,
             positions: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Full-sequence apply. Returns (h, moe_aux or None)."""
        cfg = self.cfg
        p = gather_fsdp(p, self.rules)
        hn = apply_norm(p["norm1"], h, cfg.norm)
        if self.mixer == "attn":
            mix = attn_mod.attention(p["attn"], hn, cfg, causal=self.causal,
                                     window=cfg.window, positions=positions,
                                     impl=self.impl.attn, rules=self.rules)
        else:
            mix = mamba_mod.mamba_forward(p["mamba"], hn, cfg, self.impl.ssd,
                                          rules=self.rules)
        h = h + mix
        if self.cross:
            hx = apply_norm(p["norm_x"], h, cfg.norm)
            h = h + attn_mod.attention(p["cross"], hx, cfg, causal=False,
                                       x_kv=enc, use_rope=False, impl="xla",
                                       rules=self.rules)
        return self._ffn_apply(p, h, with_aux=True)

    def prefill(self, p: dict, h: torch.Tensor, *,
                enc: torch.Tensor | None = None, pad_to: int = 0
                ) -> tuple[torch.Tensor, dict]:
        """Full-sequence apply that also emits this layer's decode cache.
        pad_to: allocate this many cache slots (> L leaves room to decode)."""
        cfg = self.cfg
        p = gather_fsdp(p, self.rules)
        L = h.shape[1]
        cache: dict[str, torch.Tensor] = {}
        hn = apply_norm(p["norm1"], h, cfg.norm)
        if self.mixer == "attn":
            mix, (ks, vs) = attn_mod.attention(
                p["attn"], hn, cfg, causal=self.causal, window=cfg.window,
                impl=self.impl.attn, return_kv=True, rules=self.rules)
            S_tot = max(pad_to, L)
            S = min(S_tot, cfg.window) if cfg.window > 0 else S_tot
            if cfg.window > 0:
                # ring buffer: position t lives at slot t % S; keep the last
                # S, a rotation of them by first % S (slices and a cat:
                # torch 2.11's DTensor has no strategy for index_put_)
                first = max(L - S, 0)
                shift = first % S
                for name, src in (("k", ks), ("v", vs)):
                    tail = src[:, :, first:]
                    if L < S:
                        tail = torch.nn.functional.pad(tail, (0, 0, 0, S - L))
                    elif shift:
                        tail = torch.cat([tail[:, :, S - shift:],
                                          tail[:, :, :S - shift]], dim=2)
                    cache[name] = tail
            elif S_tot > L:
                pad = S_tot - L
                cache["k"] = torch.nn.functional.pad(ks, (0, 0, 0, pad))
                cache["v"] = torch.nn.functional.pad(vs, (0, 0, 0, pad))
            else:
                # no decode room asked for: the keys and values as they are
                # (torch 2.11's DTensor cannot propagate a pad of 0)
                cache["k"], cache["v"] = ks, vs
            h = h + mix
        else:
            mix, (conv_tail, S_state) = mamba_mod.mamba_forward(
                p["mamba"], hn, cfg, self.impl.ssd, return_state=True,
                rules=self.rules)
            cache["conv"], cache["ssm"] = conv_tail, S_state
            h = h + mix
        if self.cross:
            hx = apply_norm(p["norm_x"], h, cfg.norm)
            mix, (xk, xv) = attn_mod.attention(
                p["cross"], hx, cfg, causal=False, x_kv=enc, use_rope=False,
                impl="xla", return_kv=True, rules=self.rules)
            cache["xk"], cache["xv"] = xk, xv
            h = h + mix
        h, _ = self._ffn_apply(p, h)
        return h, cache

    def decode(self, p: dict, h: torch.Tensor, cache: dict, cache_len: int
               ) -> tuple[torch.Tensor, dict]:
        """One-token apply. h: (B, 1, d).  The KV cache is written in
        place (see ``attention.decode_attention``)."""
        cfg = self.cfg
        p = gather_fsdp(p, self.rules)
        new_cache = dict(cache)
        hn = apply_norm(p["norm1"], h, cfg.norm)
        if self.mixer == "attn":
            mix, k2, v2 = attn_mod.decode_attention(
                p["attn"], hn, cache["k"], cache["v"], cache_len, cfg,
                window=cfg.window, rules=self.rules)
            new_cache["k"], new_cache["v"] = k2, v2
        else:
            mix, conv2, ssm2 = mamba_mod.mamba_decode_step(
                p["mamba"], hn, cache["conv"], cache["ssm"], cfg)
            new_cache["conv"], new_cache["ssm"] = conv2, ssm2
        h = h + mix
        if self.cross:
            hx = apply_norm(p["norm_x"], h, cfg.norm)
            h = h + attn_mod.cross_decode(p["cross"], hx, cache["xk"],
                                          cache["xv"], cfg, rules=self.rules)
        h, _ = self._ffn_apply(p, h)
        return h, new_cache


# =================================================================== model ======


def _hybrid_layout(cfg: ModelConfig) -> list[tuple[str, str]]:
    """(mixer, ffn) per layer inside one hybrid superblock."""
    period = cfg.attn_period
    out = []
    for j in range(period):
        mixer = "attn" if j == cfg.attn_offset else "mamba"
        ffn = "moe" if (cfg.moe_period and j % cfg.moe_period == 1) else "mlp"
        out.append((mixer, ffn))
    return out


class LM:
    """Decoder LM / enc-dec wrapper over per-layer Block stacks.

    ``device`` (default ``"cuda"``) is where ``init`` and ``init_cache``
    allocate; a CUDA device without CUDA raises (pass ``device="cpu"``).
    ``rules`` name the sharding of activations (``with_logical_constraint``,
    which acts on DTensors only) and are the default of ``param_specs`` /
    ``cache_specs``."""

    def __init__(self, cfg: ModelConfig, impl: ModelImpl | None = None, *,
                 device: torch.device | str | None = None,
                 rules: AxisRules | None = None):
        self.cfg = cfg
        self.impl = impl or ModelImpl()
        self.device = _resolve_device(device, "LM")
        self.rules = rules
        fam = cfg.family
        mk = functools.partial(Block, cfg, self.impl, rules=rules)
        if fam in ("dense", "vlm"):
            self.blocks = [mk(mixer="attn", ffn="mlp")]
            self.n_stack = cfg.num_layers
        elif fam == "moe":
            self.blocks = [mk(mixer="attn", ffn="moe")]
            self.n_stack = cfg.num_layers
        elif fam == "ssm":
            self.blocks = [mk(mixer="mamba", ffn="none")]
            self.n_stack = cfg.num_layers
        elif fam == "hybrid":
            assert cfg.num_layers % cfg.attn_period == 0
            self.blocks = [mk(mixer=m, ffn=f) for m, f in _hybrid_layout(cfg)]
            self.n_stack = cfg.num_layers // cfg.attn_period
        elif fam == "audio":
            self.enc_block = mk(mixer="attn", ffn="mlp", causal=False)
            self.blocks = [mk(mixer="attn", ffn="mlp", cross=True)]
            self.n_stack = cfg.num_layers
        else:
            raise ValueError(fam)

    # ---------------------------------------------------------- schema ------
    def _stack_entry(self, per_block) -> Any:
        """One stack entry (a layer, or a hybrid superblock) built from
        ``per_block(block)``."""
        if len(self.blocks) == 1:
            return per_block(self.blocks[0])
        return {f"l{j}": per_block(b) for j, b in enumerate(self.blocks)}

    def _layers(self) -> list[tuple[Block, str | None]]:
        """(block, key) of every layer in one stack entry, in order (key
        None: the entry is the layer itself)."""
        if len(self.blocks) == 1:
            return [(self.blocks[0], None)]
        return [(b, f"l{j}") for j, b in enumerate(self.blocks)]

    def schema(self) -> dict:
        cfg = self.cfg
        Vp = padded_vocab(cfg.vocab_size)
        sch: dict[str, Any] = {
            "embed": embed_schema(Vp, cfg.d_model, cfg.dtype),
            "blocks": [self._stack_entry(Block.schema)
                       for _ in range(self.n_stack)],
            "final_norm": norm_schema(cfg.d_model, cfg.norm),
        }
        if not cfg.tie_embeddings:
            sch["unembed"] = ParamSpec((Vp, cfg.d_model),
                                       ("vocab", "embed_table"), cfg.dtype)
        if cfg.family == "audio":
            sch["encoder"] = {
                "blocks": [self.enc_block.schema()
                           for _ in range(cfg.encoder_layers)],
                "final_norm": norm_schema(cfg.d_model, cfg.norm),
            }
        return sch

    def init(self, seed: int = 0, mesh=None) -> dict:
        """Random parameters on ``self.device`` from a generator seeded
        with ``seed`` (the reference's std rule; not its random numbers).
        Given ``mesh`` (every rank calls this), each leaf becomes a DTensor
        placed by its sanitized spec under ``self.rules`` as soon as it is
        drawn, and its full copy is freed: a rank never holds more than its
        shards and one full leaf, as the reference's ``jit(init,
        out_shardings=...)`` never does.  The values are the unsharded
        init's: every rank draws the same stream and keeps its own part."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        if mesh is None:
            return init_from_schema(gen, self.schema(), self.device)
        from torch.distributed.tensor import distribute_tensor

        def place(leaf: torch.Tensor, s: ParamSpec):
            spec = sanitize_spec(logical_spec(s.logical, self.rules, mesh),
                                 s.shape, mesh)
            return distribute_tensor(leaf, mesh, placements(spec, mesh),
                                     src_data_rank=None)

        return init_from_schema(gen, self.schema(), self.device, place)

    def abstract_params(self) -> dict:
        return abstract_from_schema(self.schema())

    def param_specs(self, rules: AxisRules | None = None, mesh=None) -> dict:
        """Specs of every parameter leaf.  The reference stacks layers
        under a leading ``"layers"`` dim (never sharded); here each layer
        is its own entry, so a leaf's spec is the reference's without that
        first ``None``."""
        return specs_from_schema(self.schema(), rules or self.rules, mesh)

    def param_count(self) -> int:
        return param_count(self.schema())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        cfg = self.cfg
        total = self.param_count()
        if cfg.num_experts and cfg.experts_per_token:
            F = cfg.moe_d_ff or cfg.d_ff
            per_expert = 3 * cfg.d_model * F
            n_moe = self._num_moe_layers()
            inactive = n_moe * (cfg.num_experts - cfg.experts_per_token) * per_expert
            return total - inactive
        return total

    def _num_moe_layers(self) -> int:
        cfg = self.cfg
        if cfg.family == "moe":
            return cfg.num_layers
        if cfg.family == "hybrid":
            return sum(f == "moe" for _, f in _hybrid_layout(cfg)) * self.n_stack
        return 0

    # --------------------------------------------------------- embedding ----
    def _embed_in(self, params, tokens, patch_embeds=None):
        h = embed_apply(params["embed"], tokens).to(self.cfg.dtype)
        if self.cfg.family == "vlm" and patch_embeds is not None:
            h = torch.cat([patch_embeds.to(h.dtype), h], dim=1)
        return with_logical_constraint(h, ("batch", "seq", "embed_act"),
                                       self.rules)

    def _unembed(self, params, h):
        table = params.get("unembed", params["embed"]["table"])
        logits = unembed_apply(table, h, self.cfg.vocab_size)
        return with_logical_constraint(logits, ("batch", "seq", "vocab"),
                                       self.rules)

    # ----------------------------------------------------------- encoder ----
    def _encode(self, params, audio_frames):
        h = audio_frames.to(self.cfg.dtype)
        full = _remat(self.enc_block.full, self.impl)
        for p in params["encoder"]["blocks"]:
            h, _ = full(p, h)
        return apply_norm(params["encoder"]["final_norm"], h, self.cfg.norm)

    # ------------------------------------------------------------ forward ---
    def hidden_states(self, params, tokens, *, patch_embeds=None,
                      audio_frames=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (h_final (B, L, d), total moe aux loss)."""
        cfg = self.cfg
        enc = self._encode(params, audio_frames) if cfg.family == "audio" else None
        h = self._embed_in(params, tokens, patch_embeds)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        layers = [(_remat(blk.full, self.impl), key)
                  for blk, key in self._layers()]
        for entry in params["blocks"]:
            for full, key in layers:
                h, a = full(entry if key is None else entry[key], h, enc=enc)
                if a is not None:
                    aux = aux + a
        h = apply_norm(params["final_norm"], h, cfg.norm)
        return h, aux

    def forward(self, params, tokens, *, patch_embeds=None, audio_frames=None
                ) -> torch.Tensor:
        """Full logits (B, L_text, vocab); vlm: logits for text positions."""
        h, _ = self.hidden_states(params, tokens, patch_embeds=patch_embeds,
                                  audio_frames=audio_frames)
        if self.cfg.family == "vlm" and patch_embeds is not None:
            h = h[:, patch_embeds.shape[1]:, :]
        return self._unembed(params, h)

    def loss(self, params, batch: dict) -> torch.Tensor:
        """Next-token cross-entropy (+ 0.01 x MoE aux), a 0-d f32 tensor.
        ``batch`` holds tensors: tokens, labels (targets per position) and
        the vlm/audio side inputs.  With ``impl.loss_chunk`` dividing L
        (and below it) the cross-entropy runs chunk by chunk over the
        sequence, each chunk rematerialized as the layers are, so only one
        chunk's logits are live."""
        cfg = self.cfg
        h, aux = self.hidden_states(
            params, batch["tokens"], patch_embeds=batch.get("patch_embeds"),
            audio_frames=batch.get("audio_frames"))
        if cfg.family == "vlm" and "patch_embeds" in batch:
            h = h[:, batch["patch_embeds"].shape[1]:, :]
        labels = batch["labels"].long()
        table = params.get("unembed", params["embed"]["table"])

        def xent(hc, lc):
            logits = unembed_apply(table, hc, cfg.vocab_size)
            logits = with_logical_constraint(logits, ("batch", "seq", "vocab"),
                                             self.rules)
            lse = _logsumexp(logits)
            gold = _pick_last(logits, lc)
            return torch.sum(lse - gold)

        C, L = self.impl.loss_chunk, h.shape[1]
        if C and L % C == 0 and L > C:
            chunk_xent = _remat(xent, self.impl)
            total = torch.zeros((), dtype=torch.float32, device=h.device)
            for c0 in range(0, L, C):
                total = total + chunk_xent(h[:, c0:c0 + C], labels[:, c0:c0 + C])
        else:
            total = xent(h, labels)
        return total / float(labels.numel()) + 0.01 * aux

    # ------------------------------------------------------------- caches ---
    def cache_schema(self, B: int, S: int) -> dict:
        return {"blocks": [self._stack_entry(
            lambda b: b.cache_schema(B, S)) for _ in range(self.n_stack)]}

    def abstract_cache(self, B: int, S: int) -> dict:
        """The cache tree on the ``meta`` device, without ``len`` (a Python
        int here, a 0-d leaf in the reference)."""
        return abstract_from_schema(self.cache_schema(B, S))

    def cache_specs(self, B: int, S: int, rules: AxisRules | None = None,
                    mesh=None) -> dict:
        return specs_from_schema(self.cache_schema(B, S), rules or self.rules,
                                 mesh)

    def init_cache(self, B: int, S: int) -> dict:
        """Zero caches on ``self.device``; ``len`` (tokens already in the
        cache) is a Python int."""
        blocks = map_schema(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=self.device),
            self.cache_schema(B, S))["blocks"]
        return {"blocks": blocks, "len": 0}

    # ------------------------------------------------------------ prefill ---
    def prefill(self, params, tokens, *, patch_embeds=None, audio_frames=None,
                pad_to: int = 0) -> tuple[torch.Tensor, dict]:
        """Returns (last-token logits (B, vocab), cache).  pad_to: total
        cache slots to allocate (> prompt length leaves decode room)."""
        cfg = self.cfg
        enc = self._encode(params, audio_frames) if cfg.family == "audio" else None
        h = self._embed_in(params, tokens, patch_embeds)
        L_total = h.shape[1]
        caches = []
        for entry in params["blocks"]:
            cache: dict[str, Any] = {}
            for blk, key in self._layers():
                h, c = blk.prefill(entry if key is None else entry[key], h,
                                   enc=enc, pad_to=pad_to)
                if key is None:
                    cache = c
                else:
                    cache[key] = c
            caches.append(cache)
        h = apply_norm(params["final_norm"], h[:, -1:, :], cfg.norm)
        logits = self._unembed(params, h)[:, 0, :]
        return logits, {"blocks": caches, "len": L_total}

    # ------------------------------------------------------------- decode ---
    def decode_step(self, params, tokens, cache) -> tuple[torch.Tensor, dict]:
        """tokens: (B, 1) -> (logits (B, vocab), new cache).  KV caches are
        updated in place; the returned dict holds the new states."""
        cfg = self.cfg
        h = self._embed_in(params, tokens)
        cache_len = cache["len"]
        new_caches = []
        for entry, c in zip(params["blocks"], cache["blocks"]):
            c2: dict[str, Any] = {}
            for blk, key in self._layers():
                if key is None:
                    h, c2 = blk.decode(entry, h, c, cache_len)
                else:
                    h, c2[key] = blk.decode(entry[key], h, c[key], cache_len)
            new_caches.append(c2)
        h = apply_norm(params["final_norm"], h, cfg.norm)
        logits = self._unembed(params, h)[:, 0, :]
        return logits, {"blocks": new_caches, "len": cache_len + 1}

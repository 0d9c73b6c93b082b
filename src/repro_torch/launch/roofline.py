"""Roofline terms of a step from an analytic flops/bytes model of the
config, against one H100's rates (``launch.mesh``):

  compute    = flops_per_chip / 989e12        (bf16 tensor-core peak)
  memory     = hbm_bytes_per_chip / 3.35e12
  collective = collective_bytes_per_chip / 450e9 (NVLink, one direction)

``analytic_cost`` and ``model_flops`` are the reference's formulas
unchanged.

The reference reads collective bytes from the compiled per-device HLO
(``collective_bytes``, each collective's output-shape bytes, multiplied by
enclosing while-loop trip counts).  There is no HLO here: a step runs
eagerly, on DTensors, so ``CollectiveCounter`` (a dispatch mode) sees every
collective as it is issued on a chip's local tensors and keeps the same
record: bytes per chip by kind plus ``_counts``, each collective counted
at its output's bytes, and a loop counted once per trip because it runs
once per trip.  It counts the local ops' FLOPs too, with
``torch.utils.flop_counter``'s formulas (FlopCounterMode's own counts
global DTensor shapes, since a mode sees a DTensor op before DTensor
splits it into local ones).
"""
from __future__ import annotations

import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# op name fragment -> kind.  Point to point: a hand-off is counted once, at
# the receiving end (recv), and a broadcast from one stage is the
# reference's collective-permute; sends are not counted.  DTensor's
# Shard(i) -> Shard(j) step is its own op, ``_dtensor.shard_dim_alltoall``.
_KINDS = (("shard_dim_alltoall", "all-to-all"),
          ("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("recv", "collective-permute"),
          ("broadcast", "collective-permute"))


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


def _kind(func) -> str | None:
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional", "_dtensor"):
        return None
    name = func._overloadpacket.__name__
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return None


# DTensor's sharding propagator runs each op on global shapes in methods of
# this prefix (``ShardingPropagator._propagate_tensor_meta*``)
_PROPAGATE = "_propagate_tensor_meta"


def _check_propagator() -> None:
    """Raise unless this torch's sharding propagator has the methods that
    ``_propagating`` looks for: under another name the counter would count
    DTensor's bookkeeping as the chip's work, and say nothing."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    if not any(n.startswith(_PROPAGATE) for n in dir(ShardingPropagator)):
        raise RuntimeError(
            f"torch {torch.__version__}: ShardingPropagator has no "
            f"{_PROPAGATE}* method; CollectiveCounter cannot tell sharding "
            "propagation from the step's own ops")


def _propagating(entry_mode) -> bool:
    """Whether the op being dispatched is DTensor's sharding propagation:
    DTensor runs each op once on global shapes, under a fake mode (a new
    one, or the active one where there is one), to learn its output's
    metadata.  That is bookkeeping, not the chip's work."""
    from torch._guards import active_fake_mode
    if active_fake_mode() is not entry_mode:
        return True
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name.startswith(_PROPAGATE):
            return True
        frame = frame.f_back
    return False


def _op_key(func, args) -> str:
    """``name(shape, shape, ...)`` of an op and its tensor arguments."""
    shapes = ", ".join("x".join(map(str, t.shape)) for t in _tensors(args))
    return f"{func._overloadpacket.__name__}({shapes})"


class CollectiveCounter(TorchDispatchMode):
    """Counts, per chip, the collectives, FLOPs and memory of everything
    that runs while it is entered: ``record()`` gives the reference's
    ``collective_bytes`` dict, ``flops`` the local ops' FLOPs, and
    ``peak_bytes`` the most bytes that tensors created in that time held
    at once (a storage counts from the op that made it until its last
    tensor is freed).

    DTensor ops are let through (``NotImplemented``), so DTensor splits
    them into local ops and collectives, which come back through this
    mode.  Functional collectives (and DTensor's all-to-all) are counted
    at their result, c10d ones at their first argument (the tensors they
    write).  Ops that DTensor runs on global shapes to propagate shardings
    (under a fake mode other than the one active at entry) are not
    counted.

    ``flops_by_op`` and ``bytes_by_op`` split ``flops`` and the collective
    bytes by op and argument shapes (``"mm(8192x1024, 1024x3072)"``,
    ``"all-gather: all_gather_into_tensor(...)"``)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        _check_propagator()
        self._flop_registry = flop_registry
        self._fake_mode = None
        self.bytes = {k: 0 for k in _COLLECTIVES}
        self.counts = {k: 0 for k in _COLLECTIVES}
        self.flops = 0
        self.flops_by_op: dict[str, int] = {}
        self.bytes_by_op: dict[str, int] = {}
        self._live: dict[int, list[int]] = {}   # storage -> [refs, bytes]
        self.live_bytes = 0
        self.peak_bytes = 0

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake_mode = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _propagating(self._fake_mode):
            return out
        self._track(args, out)
        kind = _kind(func)
        if kind is not None:
            written = out if func.namespace != "c10d" else args[0]
            n = sum(t.numel() * t.element_size() for t in _tensors(written))
            self.bytes[kind] += n
            self.counts[kind] += 1
            key = f"{kind}: {_op_key(func, args)}"
            self.bytes_by_op[key] = self.bytes_by_op.get(key, 0) + n
        else:
            count = self._flop_registry.get(func._overloadpacket)
            if count is not None:
                n = count(*args, **kwargs, out_val=out)
                self.flops += n
                key = _op_key(func, args)
                self.flops_by_op[key] = self.flops_by_op.get(key, 0) + n
        return out

    def _track(self, args, out) -> None:
        """Count storages the op created (not its inputs', as in-place ops
        and views return) as live until their last tensor is freed."""
        seen = {t.untyped_storage()._cdata for t in _tensors(args)}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in seen:
                continue
            ent = self._live.get(key)
            if ent is None:
                ent = self._live[key] = [0, st.nbytes()]
                self.live_bytes += ent[1]
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            ent[0] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ent = self._live[key]
        ent[0] -= 1
        if ent[0] == 0:
            self.live_bytes -= ent[1]
            del self._live[key]

    def record(self) -> dict:
        """{kind: bytes per chip, ..., "_counts": {kind: n}}."""
        return {**self.bytes, "_counts": dict(self.counts)}


# ------------------------------------------------------------- analytic model ---


def analytic_cost(cfg, shape, *, microbatches: int = 1, remat: bool = True,
                  chips: int = 256, model=None) -> dict[str, float]:
    """First-principles flops (global) + HBM bytes (per chip) for a step.

    Formulas (B=global batch, L=seq, d=d_model, per layer):
      attn proj flops = 2*d*hd*(H + 2*KV + H) * tokens
      attn score/av   = 2 * 2 * H*hd * L_kv * tokens      (causal: x0.5)
      mlp             = 2*d*ff*(3 gated | 2) * tokens
      moe             = (2*d*E + k*3*2*d*F) * tokens
      ssd             = (2*(2di+2N+H)*d + 2*K*cd + 2*Q*(N+H*P) + 8*H*P*N
                         + 2*di*d) * tokens
      logits          = 2*d*Vp * tokens
    train: x3 (fwd+bwd), x4 with full remat.  Memory: weights traffic x
    microbatches, optimizer r/w, activation r/w estimate, logits, KV cache.
    """
    from repro_torch.configs.base import SHAPES, padded_vocab
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, L = shape.global_batch, shape.seq_len
    d, hd = cfg.d_model, cfg.head_dim_
    H, KV = cfg.num_heads, cfg.num_kv_heads
    Vp = padded_vocab(cfg.vocab_size)
    kind = shape.kind
    decode = kind == "decode"
    tokens = B * (1 if decode else L)
    L_kv = L                                 # decode: context length
    win = cfg.window or 0

    # ---- per-layer flops per token, by layer type ----
    def attn_flops(causal: bool) -> float:
        proj = 2 * d * hd * (2 * H + 2 * KV)
        ctx = min(win, L_kv) if win else L_kv
        score = 2 * 2 * H * hd * ctx * (0.5 if (causal and not decode) else 1.0)
        return proj + score

    def mlp_flops() -> float:
        mult = 3 if cfg.activation in ("silu", "gelu") else 2
        return 2 * d * cfg.d_ff * mult

    def moe_flops() -> float:
        F = cfg.moe_d_ff or cfg.d_ff
        return 2 * d * cfg.num_experts + cfg.experts_per_token * 3 * 2 * d * F

    def ssd_flops() -> float:
        di = cfg.ssm_expand * d
        Hs = di // cfg.ssm_head_dim
        P, N, K = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
        cd = di + 2 * N
        Q = 1 if decode else min(cfg.ssm_chunk, L)
        return (2 * d * (2 * di + 2 * N + Hs) + 2 * K * cd
                + 2 * Q * (N + Hs * P) + 8 * Hs * P * N + 2 * di * d)

    per_tok = 0.0
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        per_layer = attn_flops(True) + (moe_flops() if fam == "moe"
                                        else mlp_flops())
        per_tok += cfg.num_layers * per_layer
    elif fam == "ssm":
        per_tok += cfg.num_layers * ssd_flops()
    elif fam == "hybrid":
        per = cfg.attn_period
        n_attn = cfg.num_layers // per
        n_mamba = cfg.num_layers - n_attn
        n_moe = cfg.num_layers // max(cfg.moe_period, 1)
        n_mlp = cfg.num_layers - n_moe
        per_tok += (n_attn * attn_flops(True) + n_mamba * ssd_flops()
                    + n_moe * moe_flops() + n_mlp * mlp_flops())
    elif fam == "audio":
        dec = cfg.num_layers * (attn_flops(True) + mlp_flops()
                                + attn_flops(False))  # self + mlp + cross
        per_tok += dec
    per_tok += 2 * d * Vp                               # logits
    fwd = per_tok * tokens
    if fam == "audio" and not decode:
        enc_tokens = B * cfg.encoder_frames
        fwd += enc_tokens * cfg.encoder_layers * (attn_flops(False) + mlp_flops())

    if kind == "train":
        flops = fwd * (4.0 if remat else 3.0)
    else:
        flops = fwd

    # ---- per-chip HBM bytes ----
    if model is not None:
        P_total = model.param_count()
        P_active = model.active_param_count()
    else:
        P_total = P_active = 0
    pb = 2.0 * P_total / chips                      # param shard bytes (bf16)
    act_unit = tokens * cfg.num_layers * d * 2.0 / chips   # one act tensor
    if kind == "train":
        weights = 3.0 * microbatches * pb           # fwd+bwd+remat, per mb
        optimizer = (4 + 4 + 4 + 4 + 2 + 2) * P_total / chips
        acts = act_unit * 24.0                      # ~12 r/w pairs per layer
        logits_b = tokens * Vp * 8.0 / chips
        hbm = weights + optimizer + acts + logits_b
    elif kind == "prefill":
        hbm = pb + act_unit * 8.0 + tokens * Vp * 4.0 / chips
    else:  # decode
        kv_bytes = 0.0
        if fam in ("dense", "vlm", "moe", "audio"):
            S_eff = min(win, L) if win else L
            kv_bytes = cfg.num_layers * B * KV * S_eff * hd * 2 * 2.0
        elif fam == "hybrid":
            n_attn = cfg.num_layers // cfg.attn_period
            kv_bytes = n_attn * B * KV * L * hd * 2 * 2.0
            di = cfg.ssm_expand * d
            Hs = di // cfg.ssm_head_dim
            kv_bytes += (cfg.num_layers - n_attn) * B * Hs * cfg.ssm_head_dim \
                * cfg.ssm_state * 4.0
        elif fam == "ssm":
            di = cfg.ssm_expand * d
            Hs = di // cfg.ssm_head_dim
            kv_bytes = cfg.num_layers * B * Hs * cfg.ssm_head_dim \
                * cfg.ssm_state * 4.0
        hbm = 2.0 * P_active / chips + kv_bytes / chips + tokens * Vp * 4.0 / chips

    return {"flops_global": flops, "hbm_bytes_per_chip": hbm,
            "flops_per_chip": flops / chips}


def roofline_terms(flops_per_chip: float, hbm_bytes_per_chip: float,
                   coll_bytes_per_chip: float) -> dict[str, float]:
    compute = flops_per_chip / PEAK_FLOPS_BF16
    memory = hbm_bytes_per_chip / HBM_BW
    collective = coll_bytes_per_chip / NVLINK_BW
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dominant = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    return {**terms, "dominant": dominant,
            "roofline_fraction": compute / bound if bound > 0 else 0.0}


def model_flops(cfg, shape, active_params: int) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); forward-only shapes
    use 2*N*D; decode: D = batch tokens."""
    from repro_torch.configs.base import SHAPES
    if isinstance(shape, str):
        shape = SHAPES[shape]
    if shape.kind == "train":
        return 6.0 * active_params * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active_params * shape.global_batch * shape.seq_len
    return 2.0 * active_params * shape.global_batch

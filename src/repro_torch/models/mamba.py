"""Mamba2 (SSD — state-space duality) mixer block.

Chunked SSD forward for prefill (quadratic within chunks, linear state carry
across chunks) and an O(1)-state decode step.  B/C are single-group (G=1),
shared across heads, per the Mamba2 default.  `impl="kernel"` runs the scan
through the SSD kernel (`kernels.ops.ssd_scan`); `impl="xla"` keeps the
reference's chunked einsum path in plain torch.

Jamba's mamba layers reuse this block with their own (smaller) state size,
as in the reference (which adapts Jamba's Mamba-1 layers to SSD).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec, rmsnorm
from repro_torch.sharding.specs import (AxisRules, per_shard,
                                        with_logical_constraint)

# on a mesh the SSD core runs per (batch, head) shard: the scan runs along
# seq, so seq reaches it whole whatever the rules say
_SSD_X = ("batch", None, "ssm_inner", None)        # xh, y: (B, L, H, P)
_SSD_DT = ("batch", None, "ssm_inner")             # dt: (B, L, H)
_SSD_A = ("ssm_inner",)                            # A: (H,)
_SSD_BC = ("batch", None, None)                    # B, C: (B, L, N)
_SSD_STATE = ("batch", "ssm_inner", None, None)    # states: (B, H, P, N)


def mamba_dims(cfg: ModelConfig) -> dict[str, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N          # x, B, C share the causal conv (G=1)
    return dict(d_inner=d_inner, H=H, P=cfg.ssm_head_dim, N=N, conv_dim=conv_dim)


def mamba_schema(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    dims = mamba_dims(cfg)
    di, H, N, cd = dims["d_inner"], dims["H"], dims["N"], dims["conv_dim"]
    dt = cfg.dtype
    f32 = torch.float32
    return {
        "in_proj": ParamSpec((d, 2 * di + 2 * N + H), ("embed", "ssm_inner"), dt),
        "conv_w": ParamSpec((cd, cfg.ssm_conv), ("ssm_inner", "conv"), dt,
                            scale=0.5),
        "conv_b": ParamSpec((cd,), ("ssm_inner",), dt, "zeros"),
        "A_log": ParamSpec((H,), ("ssm_inner",), f32, "ones"),
        "D": ParamSpec((H,), ("ssm_inner",), f32, "ones"),
        "dt_bias": ParamSpec((H,), ("ssm_inner",), f32, "zeros"),
        "norm_scale": ParamSpec((di,), ("ssm_inner",), f32, "ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed"), dt),
    }


def _split_proj(p: dict, x: torch.Tensor, cfg: ModelConfig,
                rules: AxisRules | None = None):
    dims = mamba_dims(cfg)
    di, N = dims["d_inner"], dims["N"]
    # z, x, B, C and dt are slices of one projection: split by batch only
    zxbcdt = with_logical_constraint(x @ p["in_proj"], ("batch", "seq", None),
                                     rules)
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * N]
    dt = zxbcdt[..., di + di + 2 * N:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv over seq. xBC: (B, L, C); w: (C, K)."""
    K = w.shape[1]
    L = xBC.shape[1]
    if state is None:
        pad = xBC.new_zeros(xBC.shape[:1] + (K - 1,) + xBC.shape[2:])
    else:
        pad = state                                  # (B, K-1, C)
    xp = torch.cat([pad, xBC], dim=1)                # (B, L+K-1, C)
    out = xp[:, 0:L, :] * w[:, 0][None, None, :]
    for i in range(1, K):
        out = out + xp[:, i:i + L, :] * w[:, i][None, None, :]
    return F.silu(out + b[None, None, :])


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bs: torch.Tensor, Cs: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None,
                impl: str = "kernel") -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh: (B, L, H, P) head inputs; dt: (B, L, H) step sizes (post-softplus);
    A: (H,) negative decay rates; Bs/Cs: (B, L, N) single-group state in/out.
    Returns (y (B, L, H, P), final_state (B, H, P, N)).
    """
    if impl == "kernel":
        return ops.ssd_scan(xh.contiguous(), dt.contiguous(), A,
                            Bs.contiguous(), Cs.contiguous(), chunk=chunk,
                            init_state=init_state)

    B, L, H, P = xh.shape
    N = Bs.shape[-1]
    Q = min(chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q
    f32 = torch.float32
    dev = xh.device

    xc = xh.reshape(B, nc, Q, H, P)
    dtc = dt.reshape(B, nc, Q, H).float()
    Bc = Bs.reshape(B, nc, Q, N)
    Cc = Cs.reshape(B, nc, Q, N)
    a = dtc * A[None, None, None, :]                 # (B, nc, Q, H) log-decay
    cs = torch.cumsum(a, dim=2)                       # inclusive cumsum

    S = (torch.zeros((B, H, P, N), dtype=f32, device=dev) if init_state is None
         else init_state.float())
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    tri = tri[None, :, :, None]
    ys = []
    for c in range(nc):
        xq, dtq, Bq, Cq, csq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c], cs[:, c]
        # intra-chunk (quadratic within the chunk)
        # exp of the masked (j > i) differences overflows; masking before
        # the exp keeps their gradient 0 instead of 0 * inf = nan
        seg = csq[:, :, None, :] - csq[:, None, :, :]                 # (B,Q,Q,H)
        decay = torch.exp(torch.where(tri, seg, -torch.inf))
        G = Cq.float() @ Bq.float().transpose(-1, -2)                 # (B,Q,Q)
        W = torch.where(tri, G[..., None] * decay, 0.0)               # (B,Q,Q,H)
        xdt = xq.float() * dtq[..., None]                             # (B,Q,H,P)
        y_intra = torch.einsum("bijh,bjhp->bihp", W, xdt)
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("bin,bhpn,bih->bihp", Cq.float(), S,
                               torch.exp(csq))
        # state update
        total = csq[:, -1, :]                                         # (B,H)
        carry_decay = torch.exp(total[:, None, :] - csq)              # (B,Q,H)
        dS = torch.einsum("bjn,bjhp,bjh->bhpn", Bq.float(), xdt, carry_decay)
        S = S * torch.exp(total)[:, :, None, None] + dS
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, L, H, P).to(xh.dtype)
    return y, S


def mamba_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  impl: str = "kernel",
                  conv_state: torch.Tensor | None = None,
                  ssm_state: torch.Tensor | None = None,
                  return_state: bool = False,
                  rules: AxisRules | None = None):
    """Full-sequence mamba mixer. x: (B, L, d) -> (B, L, d)."""
    dims = mamba_dims(cfg)
    di, H, P, N = dims["d_inner"], dims["H"], dims["P"], dims["N"]
    B, L, _ = x.shape
    z, xBC_raw, dt = _split_proj(p, x, cfg, rules)
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"], conv_state)
    xs, Bs, Cs = xBC[..., :di], xBC[..., di:di + N], xBC[..., di + N:]
    xh = xs.reshape(B, L, H, P)
    xh = with_logical_constraint(xh, ("batch", "seq", "ssm_inner", None), rules)
    A = -torch.exp(p["A_log"].float())
    y, S = per_shard(
        lambda *a: ssd_chunked(*a[:5], cfg.ssm_chunk, a[5], impl),
        (xh, dt, A, Bs, Cs, ssm_state),
        (_SSD_X, _SSD_DT, _SSD_A, _SSD_BC, _SSD_BC, _SSD_STATE),
        [(_SSD_X, xh.shape), (_SSD_STATE, (B, H, P, N))], rules)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B, L, di)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm_scale"])
    out = with_logical_constraint(y @ p["out_proj"],
                                  ("batch", "seq", "embed_act"), rules)
    if return_state:
        # conv state for prefill->decode handoff: last K-1 *raw* conv inputs
        K = cfg.ssm_conv
        pad = x.new_zeros((B, K - 1, dims["conv_dim"]))
        conv_tail = torch.cat([pad, xBC_raw.to(x.dtype)], dim=1)[:, -(K - 1):, :]
        return out, (conv_tail, S)
    return out


def mamba_decode_step(p: dict, x: torch.Tensor, conv_state: torch.Tensor,
                      ssm_state: torch.Tensor, cfg: ModelConfig):
    """One-token decode. x: (B, 1, d); conv_state: (B, K-1, conv_dim);
    ssm_state: (B, H, P, N).  Returns (out, new_conv_state, new_ssm_state)."""
    dims = mamba_dims(cfg)
    di, H, P, N = dims["d_inner"], dims["H"], dims["P"], dims["N"]
    B = x.shape[0]
    f32 = torch.float32
    z, xBC, dt = _split_proj(p, x, cfg)               # xBC: (B, 1, conv_dim)
    window = torch.cat([conv_state, xBC], dim=1)      # (B, K, conv_dim)
    conv_out = torch.einsum("bkc,ck->bc", window.float(), p["conv_w"].float())
    conv_out = F.silu(conv_out + p["conv_b"].float())
    xs = conv_out[:, :di]
    Bs = conv_out[:, di:di + N]
    Cs = conv_out[:, di + N:]
    xh = xs.reshape(B, H, P).to(f32)
    A = -torch.exp(p["A_log"].float())
    dt1 = dt[:, 0, :]                                 # (B, H)
    dA = torch.exp(dt1 * A[None, :])                  # (B, H)
    dBx = torch.einsum("bn,bhp,bh->bhpn", Bs.float(), xh, dt1)
    S = ssm_state.float() * dA[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cs.float(), S)
    y = y + p["D"].float()[None, :, None] * xh
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm_scale"])
    out = y @ p["out_proj"]
    return out, window[:, 1:, :], S.to(ssm_state.dtype)

"""Plain PyTorch versions of the port's kernels (CPU path and oracles)."""
from __future__ import annotations

import math

import torch


def policy_mlp_ref(x, w1, b1, w2, b2, w3, b3, mask):
    """Masked actor logits: tanh(tanh(x w1 + b1) w2 + b2) w3 + b3, with
    rows where ``mask <= 0`` set to -1e9.  (Q, F) ... (Q,) -> (Q,) f32."""
    h = torch.tanh(x.float() @ w1.float() + b1)
    h = torch.tanh(h @ w2.float() + b2)
    logits = (h @ w3.float() + b3)[:, 0]
    return torch.where(mask > 0, logits, torch.full_like(logits, -1e9))


def predict_mlp_ref(x, w1, b1, w2, b2, w3, b3):
    """Quantile-head residuals: tanh(tanh(x w1 + b1) w2 + b2) w3 + b3.
    (B, F) ... (H2, Q), (Q,) -> (B, Q) f32."""
    h = torch.tanh(x.float() @ w1.float() + b1)
    h = torch.tanh(h @ w2.float() + b2)
    return h @ w3.float() + b3


NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Naive masked softmax attention in f32.  q: (B, H, L, D); k, v:
    (B, KV, L, D) with H a multiple of KV (query head h reads KV head
    h // (H // KV)) -> (B, H, L, D) in q's dtype.  Masked scores are -1e30,
    scores scaled by 1/sqrt(D)."""
    B, H, L, D = q.shape
    G = H // k.shape[1]
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = (q.float() @ kf.transpose(-1, -2)) / math.sqrt(D)
    pos = torch.arange(L, device=q.device)
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return (torch.softmax(s, dim=-1) @ vf).to(q.dtype)


def ssd_init_share(dt, A, Cs, init_state):
    """The initial state's share of the SSD output, exp(cs_t) C_t . S0, in
    f32.  dt (B, L, H), A (H,), Cs (B, L, N), init_state (B, H, P, N) ->
    (B, L, H, P), cs the inclusive cumsum of dt * A over the sequence."""
    cs = torch.cumsum(dt.float() * A.float(), dim=1)        # (B, L, H)
    return torch.einsum("bln,bhpn,blh->blhp", Cs.float(), init_state.float(),
                        torch.exp(cs))


def ssd_scan_ref(xh, dt, A, Bs, Cs, init_state=None):
    """Naive quadratic SSD (the 1-semiseparable attention form), one batch
    row at a time.  xh: (B, L, H, P); dt: (B, L, H) f32; A: (H,) f32;
    Bs/Cs: (B, L, N); init_state: (B, H, P, N) or None.

        y[t] = sum_{s<=t} (C_t . B_s) exp(cs_t - cs_s) dt_s x_s
               + exp(cs_t) C_t . S0
        S    = sum_s exp(cs_L - cs_s) dt_s x_s B_s^T + exp(cs_L) S0

    with cs the inclusive cumsum of dt * A over the sequence.  As the
    reference's wrapper does, y is rounded twice when an initial state is
    given: the scan from a zero state is rounded to xh's dtype, then the
    initial state's share (``ssd_init_share``) is added in f32 and the sum
    rounded again.  Returns (y (B, L, H, P) in xh's dtype, final state
    (B, H, P, N) f32)."""
    B, L, H, P = xh.shape
    N = Bs.shape[-1]
    ys, states = [], []
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xh.device))
    for b in range(B):
        x = xh[b].float().permute(1, 0, 2)                 # (H, L, P)
        d = dt[b].float().T                                 # (H, L)
        cs = torch.cumsum(d * A.float()[:, None], dim=-1)   # (H, L)
        expo = cs[:, :, None] - cs[:, None, :]              # (H, t, s)
        decay = torch.exp(torch.where(tri, expo, torch.full_like(expo,
                                                                 -math.inf)))
        Bb, Cb = Bs[b].float(), Cs[b].float()               # (L, N)
        W = (Cb @ Bb.T)[None] * decay                       # (H, t, s)
        xdt = x * d[:, :, None]                             # (H, L, P)
        y = W @ xdt                                         # (H, L, P)
        carry = torch.exp(cs[:, -1:] - cs)                  # (H, L)
        S = (xdt * carry[:, :, None]).transpose(1, 2) @ Bb  # (H, P, N)
        if init_state is not None:
            S = S + init_state[b].float() * torch.exp(cs[:, -1])[:, None, None]
        ys.append(y.permute(1, 0, 2))
        states.append(S)
    y = torch.stack(ys).to(xh.dtype)
    if init_state is not None:
        y = (y.float() + ssd_init_share(dt, A, Cs, init_state)).to(xh.dtype)
    return y, torch.stack(states).reshape(B, H, P, N)


def moe_router_ref(x, router_w, k: int):
    """Router logits x W in f32, top-k by k masked argmax passes (ties go to
    the lowest expert index, as ``lax.top_k`` and the kernel break them),
    softmax over the k.  x (T, d), W (d, E) -> (weights (T, k) f32,
    indices (T, k) int32)."""
    work = x.float() @ router_w.float()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(work, dim=-1, keepdim=True)       # first maximum
        vals.append(torch.gather(work, -1, i))
        idxs.append(i)
        work = work.scatter(-1, i, NEG_INF)
    v = torch.cat(vals, dim=-1)
    return torch.softmax(v, dim=-1), torch.cat(idxs, dim=-1).to(torch.int32)

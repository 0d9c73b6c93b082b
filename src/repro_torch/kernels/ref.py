"""Plain PyTorch versions of the port's kernels (CPU path and oracles)."""
from __future__ import annotations

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

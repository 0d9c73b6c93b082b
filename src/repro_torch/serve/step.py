"""Serving step factories: prefill (full forward + cache build) and decode
(one token against the cache)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.lm import LM


def make_prefill_step(model: LM) -> Callable:
    def prefill_step(params, batch: dict):
        return model.prefill(params, batch["tokens"],
                             patch_embeds=batch.get("patch_embeds"),
                             audio_frames=batch.get("audio_frames"))
    return prefill_step


def make_decode_step(model: LM) -> Callable:
    """Greedy decode: ``torch.argmax`` takes the first maximum, as
    ``jnp.argmax`` does."""
    def decode_step(params, tokens, cache):
        logits, cache = model.decode_step(params, tokens, cache)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache
    return decode_step

"""Batched serving engine over a request queue.

Requests (prompt token lists) are taken in fixed-size batches, left-padded
to the batch's longest prompt, prefilled together into caches of
``max_len`` slots, and decoded greedily one fused step at a time for the
whole batch until the longest request is done.  A short last batch is
filled with dummy one-token requests.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.agent import _resolve_device
from repro_torch.models.lm import LM
from repro_torch.serve.step import make_decode_step


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: list[int]
    max_new_tokens: int = 16
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Serves ``model`` (with ``params`` on ``device``, default
    ``"cuda"``; raises without CUDA unless ``device="cpu"``) under
    ``torch.inference_mode()``."""

    def __init__(self, model: LM, params, *, batch_size: int = 4,
                 max_len: int = 256, eos_id: int = -1,
                 device: torch.device | str | None = None):
        self.device = _resolve_device(device, "ServeEngine")
        self.model = model
        self.params = params
        self.B = batch_size
        self.S = max_len
        self.eos_id = eos_id
        self._decode = make_decode_step(model)

    def _prefill_batch(self, reqs: list[Request]):
        """Left-pad prompts to a common length, prefill, return the first
        generated token of each row (B, 1) and the cache."""
        assert len(reqs) == self.B
        L = max(len(r.prompt) for r in reqs)
        toks = np.zeros((self.B, L), np.int32)
        for i, r in enumerate(reqs):
            toks[i, L - len(r.prompt):] = r.prompt     # left-pad with 0
        logits, cache = self.model.prefill(
            self.params, torch.from_numpy(toks).to(self.device), pad_to=self.S)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, cache

    @torch.inference_mode()
    def run(self, requests: list[Request]) -> list[Request]:
        """Serve all requests to completion; returns them with outputs."""
        queue = list(requests)
        done: list[Request] = []
        while queue:
            batch = queue[:self.B]
            queue = queue[self.B:]
            while len(batch) < self.B:            # pad with a dummy request
                batch.append(Request(req_id=-1, prompt=[0], max_new_tokens=1))
            tok, cache = self._prefill_batch(batch)
            first = tok[:, 0].tolist()
            for i, r in enumerate(batch):
                if r.req_id >= 0:
                    r.output.append(first[i])
            steps = max(r.max_new_tokens for r in batch) - 1
            for _ in range(max(steps, 0)):
                tok, _, cache = self._decode(self.params, tok, cache)
                row = tok[:, 0].tolist()
                for i, r in enumerate(batch):
                    if r.req_id < 0 or r.done:
                        continue
                    t = row[i]
                    if len(r.output) < r.max_new_tokens:
                        r.output.append(t)
                    if t == self.eos_id or len(r.output) >= r.max_new_tokens:
                        r.done = True
            done.extend(r for r in batch if r.req_id >= 0)
        return done

"""Deterministic synthetic LM data pipeline.

Tokens are generated from a seeded counter-based generator (Philox via
numpy), so step `k` always yields the same batch — restart-safe (a job that
restarts from a checkpoint at step k resumes the exact data stream) and
host-shardable (each host materializes only its slice of the global batch).
The same ``(seed, step)`` gives the reference's tokens bit for bit.

A light Markov structure makes the stream learnable (loss goes down), not
just uniform noise.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    markov_order: bool = True

    def __post_init__(self) -> None:
        assert self.global_batch % self.num_hosts == 0
        self.local_batch = self.global_batch // self.num_hosts
        # fixed random transition offsets: token_{t+1} ~ f(token_t) + noise
        rng = np.random.default_rng(self.seed ^ 0x5EED)
        self._jump = rng.integers(1, self.vocab_size,
                                  size=(256,), dtype=np.int64)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """{tokens, labels} of shape (local_batch, seq_len), deterministic."""
        rng = np.random.default_rng(
            (np.int64(self.seed) << 20) + np.int64(step) * self.num_hosts
            + self.host_id)
        B, L, V = self.local_batch, self.seq_len, self.vocab_size
        noise = rng.integers(0, V, size=(B, L + 1), dtype=np.int64)
        if self.markov_order:
            toks = np.empty((B, L + 1), dtype=np.int64)
            toks[:, 0] = noise[:, 0]
            mix = rng.random((B, L)) < 0.85
            for t in range(L):
                nxt = (toks[:, t] + self._jump[toks[:, t] % 256]) % V
                toks[:, t + 1] = np.where(mix[:, t], nxt, noise[:, t + 1])
        else:
            toks = noise
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def batch_for(cfg, shape, *, step: int = 0, seed: int = 0,
              num_hosts: int = 1, host_id: int = 0) -> dict[str, np.ndarray]:
    """Concrete numpy batch matching `input_specs(cfg, shape)` (for
    runnable tests)."""
    from repro_torch.configs.base import SHAPES, input_specs
    if isinstance(shape, str):
        shape = SHAPES[shape]
    specs = input_specs(cfg, shape)
    tok_shape = specs["tokens"][0]
    ds = SyntheticLMDataset(cfg.vocab_size, tok_shape[1], tok_shape[0],
                            seed=seed, num_hosts=num_hosts, host_id=host_id)
    batch = dict(ds.batch_at(step))
    if "labels" not in specs:
        batch.pop("labels")
    rng = np.random.default_rng(seed + 17)
    for key in ("patch_embeds", "audio_frames"):
        if key in specs:
            s = specs[key][0]
            local = (s[0] // num_hosts,) + s[1:]
            batch[key] = (rng.standard_normal(local) * 0.02).astype("float32")
    return batch

"""Shape-bucketed batch scoring over the fused policy-MLP kernel.

Deep queue windows (qw >> MAX_QUEUE_SIZE=256) leave the actor blind to the
tail: ``RLPrioritizer`` ranks the first 256 jobs and keeps everything beyond
in FIFO order.  ``BucketedScorer`` scores arbitrary-length feature batches
through the same fused MLP (``kernels/policy_mlp.py`` on the GPU,
``kernels/ref.py`` on the CPU) so the tail can be ordered by the policy too.
The batch is padded up to a power-of-two bucket, as in the reference, so a
whole run launches the kernel at log2 many shapes; batches beyond the
largest bucket are scored in bucket-size chunks.  Padded rows are masked and
sliced away.

The scorer is opt-in end to end: nothing routes through it unless a caller
passes one to ``RLPrioritizer(deep_scorer=...)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

#: bucket ladder bounds: the smallest bucket matches the actor window, the
#: largest caps the padded shape at 16k-deep queues
MIN_BUCKET = 256
MAX_BUCKET = 16384


def bucket_for(n: int, *, lo: int = MIN_BUCKET, hi: int = MAX_BUCKET) -> int:
    """Smallest power-of-two bucket >= n, clamped to [lo, hi]."""
    b = lo
    while b < n and b < hi:
        b <<= 1
    return b


class BucketedScorer:
    """Batch-score (n, F) feature rows with the fused policy MLP.

    ``params`` is the actor parameter list (``agent.params["actor"]``:
    three ``{"w", "b"}`` layers of tensors); the rows are scored on the
    device those tensors live on.  ``score`` pads the batch to its bucket,
    runs the MLP once per chunk, and returns the real rows' logits as
    float32 numpy.  ``compiled_buckets`` lists the bucket shapes scored so
    far (the reference's name: there it counts jit compilations).
    """

    def __init__(self, params: list[dict], *, max_bucket: int = MAX_BUCKET):
        self.params = params
        self.device = params[0]["w"].device
        self.max_bucket = int(max_bucket)
        self._buckets: set[int] = set()

    @property
    def compiled_buckets(self) -> tuple[int, ...]:
        return tuple(sorted(self._buckets))

    def _score_bucket(self, x_pad: np.ndarray, mask: np.ndarray) -> np.ndarray:
        self._buckets.add(x_pad.shape[0])
        with torch.no_grad():
            out = ops.policy_mlp(torch.from_numpy(x_pad).to(self.device),
                                 self.params,
                                 torch.from_numpy(mask).to(self.device))
        return out.cpu().numpy()

    def score(self, feats: np.ndarray) -> np.ndarray:
        """(n, F) float32 rows -> (n,) float32 logits (masked rows never
        leak: padding is scored at -1e9 and sliced away)."""
        feats = np.asarray(feats, dtype=np.float32)
        n = feats.shape[0]
        if n == 0:
            return np.zeros((0,), dtype=np.float32)
        out = np.empty((n,), dtype=np.float32)
        for lo in range(0, n, self.max_bucket):
            chunk = feats[lo:lo + self.max_bucket]
            m = chunk.shape[0]
            b = bucket_for(m, hi=self.max_bucket)
            x_pad = np.zeros((b, feats.shape[1]), dtype=np.float32)
            x_pad[:m] = chunk
            mask = np.zeros((b,), dtype=np.float32)
            mask[:m] = 1.0
            out[lo:lo + m] = self._score_bucket(x_pad, mask)[:m]
        return out

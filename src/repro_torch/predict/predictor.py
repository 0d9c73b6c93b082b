"""Online runtime prediction (`repro_torch.predict`) — learned estimates for
EASY backfill reservations, MILP lookahead durations, and autoscaler
demand forecasts.

The paper's application-agnostic constraint is respected: the predictor
learns **only from observed telemetry** — the engine hook stream of
submissions and completions — with no per-job offline profiling.  Each
completed job contributes one online SGD step; each pending job can be
scored at any time.

Model: a small quantile-head MLP (numpy SGD and single-row forward on the
host; every batched forward through ``repro_torch.kernels.ops.predict_mlp``
on the predictor's device, the hand-written CUDA kernel on a GPU) over the
existing 17 ``repro_torch.core.features`` job features plus 4
cluster-context features.  The heads predict **log-runtime
residuals over a debiased estimate anchor**:

    anchor(job)  = est_runtime * exp(bias[user, gpus-bucket])
    q_tau(job)   = anchor(job) * exp(f_tau(x)),   tau in {0.5, 0.9}

where ``bias`` is the running mean of observed ``log(actual / est)`` per
(user, gpus-bucket) — the per-cohort *systematic* mis-estimation (users
who habitually pad their walltime request, or habitually lowball it) —
and the MLP heads, trained with the pinball (quantile) loss, capture the
residual quantiles on top of the corrected anchor.  The split matters:
cohort identity is a lookup, not something a tiny MLP can carve out of a
scalar user-id feature, while the remaining noise *is* feature-shaped.
All tables start empty and every head initializes to zero, so the
*untrained* predictor reproduces the declared estimate exactly — assist
mode can be enabled from the first job without a cold-start cliff.  A trivial per-(user, gpus-bucket) running-mean
baseline is trained alongside from the same stream; the MLP's prequential
MAPE must beat it (gated in ``benchmarks/bench_prediction.py``).

Shadow mode (``assist=False``) trains from the hook stream but is never
consulted by the engine — pinned bit-identical to ``predictor=None`` on
every registered scenario, the same off-path discipline as
obs/chaos/autoscaler-off.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque

import numpy as np
import torch

from repro_torch.core.agent import _resolve_device
from repro_torch.core.features import NUM_FEATURES, build_features
from repro_torch.sched.engine import EngineHooks
from repro_torch.core.types import Job
from repro_torch.kernels import ops

#: cluster-context features appended to the 17 core job features
CONTEXT_NAMES = ("utilization", "pending_norm", "running_norm", "free_frac")
NUM_CONTEXT = len(CONTEXT_NAMES)
PREDICT_FEATURES = NUM_FEATURES + NUM_CONTEXT

#: log-residual clamp: e^4 ~ 55x either way — far wider than any real
#: mis-estimation pattern, tight enough that one bad SGD step can never
#: emit an inf/NaN reservation
RESID_CLAMP = 4.0


def _gpu_bucket(num_gpus: int) -> int:
    """Power-of-two GPU-count bucket (1, 2, 3-4, 5-8, ...)."""
    return max(int(num_gpus), 0).bit_length()


class QuantileMLP:
    """Tiny tanh MLP with one linear head per quantile, trained online with
    the pinball loss by manual numpy backprop (single-sample SGD).

    The head layer initializes to zero so the untrained network outputs a
    zero log-residual for every input — predictions start exactly at the
    anchor.  Parameter layout matches the fused kernel
    (``repro_torch.kernels.predict_mlp``): w1/b1/w2/b2/w3/b3, float32.
    ``updates`` counts the in-place changes to ``params`` (one per
    ``sgd_step``); whoever rewrites ``params`` otherwise bumps it too, so a
    copy of the weights on a device knows when it is stale.
    """

    def __init__(self, num_features: int = PREDICT_FEATURES,
                 hidden: tuple[int, int] = (24, 12),
                 quantiles: tuple[float, ...] = (0.5, 0.9),
                 lr: float = 0.05, seed: int = 0):
        h1, h2 = hidden
        q = len(quantiles)
        rng = np.random.default_rng(seed)
        self.quantiles = tuple(float(t) for t in quantiles)
        self.lr = float(lr)
        self.params = {
            "w1": (rng.standard_normal((num_features, h1))
                   / math.sqrt(num_features)).astype(np.float32),
            "b1": np.zeros(h1, np.float32),
            "w2": (rng.standard_normal((h1, h2))
                   / math.sqrt(h1)).astype(np.float32),
            "b2": np.zeros(h2, np.float32),
            "w3": np.zeros((h2, q), np.float32),
            "b3": np.zeros(q, np.float32),
        }
        self.updates = 0

    def forward(self, x: np.ndarray) -> np.ndarray:
        """(n, F) -> (n, Q) log-runtime residuals, float32."""
        p = self.params
        h1 = np.tanh(x @ p["w1"] + p["b1"])
        h2 = np.tanh(h1 @ p["w2"] + p["b2"])
        return h2 @ p["w3"] + p["b3"]

    def sgd_step(self, x: np.ndarray, y: float) -> float:
        """One pinball-loss SGD step on a single (features, log-residual)
        pair; returns the summed pinball loss before the update."""
        p = self.params
        x = np.asarray(x, np.float32)
        h1 = np.tanh(x @ p["w1"] + p["b1"])
        h2 = np.tanh(h1 @ p["w2"] + p["b2"])
        q = h2 @ p["w3"] + p["b3"]
        taus = np.asarray(self.quantiles, np.float32)
        diff = np.float32(y) - q
        loss = float(np.sum(np.maximum(taus * diff, (taus - 1.0) * diff)))
        # dL/dq per head: (1 - tau) when over-predicting, -tau when under
        g = np.where(q >= y, 1.0 - taus, -taus).astype(np.float32)
        dw3 = np.outer(h2, g)
        dh2 = p["w3"] @ g
        dz2 = dh2 * (1.0 - h2 * h2)
        dw2 = np.outer(h1, dz2)
        dh1 = p["w2"] @ dz2
        dz1 = dh1 * (1.0 - h1 * h1)
        dw1 = np.outer(x, dz1)
        lr = self.lr
        p["w3"] -= lr * dw3
        p["b3"] -= lr * g
        p["w2"] -= lr * dw2
        p["b2"] -= lr * dz2
        p["w1"] -= lr * dw1
        p["b1"] -= lr * dz1
        self.updates += 1
        return loss


class RunningMeanBaseline:
    """Trivial per-(user, gpus-bucket) running mean of observed runtimes —
    the floor the MLP must beat on MAPE.  Falls back to the global mean,
    then to the declared estimate, when a key has no observations yet."""

    def __init__(self):
        self._sum: dict[tuple[int, int], float] = {}
        self._n: dict[tuple[int, int], int] = {}
        self._gsum = 0.0
        self._gn = 0

    def predict(self, job: Job) -> float:
        key = (job.user, _gpu_bucket(job.num_gpus))
        n = self._n.get(key, 0)
        if n:
            return self._sum[key] / n
        if self._gn:
            return self._gsum / self._gn
        return max(float(job.est_runtime), 1.0)

    def observe(self, job: Job, runtime: float) -> None:
        key = (job.user, _gpu_bucket(job.num_gpus))
        self._sum[key] = self._sum.get(key, 0.0) + runtime
        self._n[key] = self._n.get(key, 0) + 1
        self._gsum += runtime
        self._gn += 1


@dataclasses.dataclass
class OverrunPolicy:
    """Checkpoint economics for reservation overruns.  Duck-type-compatible
    with ``CkptCostModel`` (``ckpt_interval`` + ``resume_penalty``), so the
    engine charges the overrun through the normal ``preempt_job`` path."""

    grace_s: float = 60.0          # slack past the deadline before eviction
    ckpt_interval: float = 900.0   # progress floors to this grid
    penalty_s: float = 600.0       # replayed restore work, in work-seconds

    def resume_penalty(self, job: Job) -> float:
        return self.penalty_s


class RuntimePredictor(EngineHooks):
    """Online quantile runtime predictor, attached as an engine hook.

    Subclassing ``EngineHooks`` matters twice over: under a ``MultiHooks``
    the dispatch filter skips every inherited no-op (only ``on_submit`` /
    ``on_finish`` count as defined), and when ``load_state`` re-attaches
    the pickled predictor *directly* to ``engine.hooks`` the inherited
    no-ops absorb the rest of the hook surface.

    Training loop (no profiling, observed telemetry only):

    - ``on_submit`` caches the job's 17-dim feature row (cluster state at
      submission) keyed by job id;
    - ``on_finish`` pairs it with the observed runtime, records the
      *prequential* MLP/baseline errors (predict-then-update, so reported
      MAPE is honest out-of-sample error), takes one pinball SGD step per
      quantile head, folds ``log(actual / est)`` into the per-(user,
      gpus-bucket) anchor bias, feeds the running-mean baseline, and
      evicts the row.

    Consumers (engine-driven, all read-only):

    - ``reserve_batch`` / ``reserve_runtime``: p90 reservations for EASY
      backfill gating;
    - ``lookahead_durations``: p50 durations for the MILP lookahead terms;
    - ``pending_gpu_hours``: predicted GPU-hours of the pending window for
      autoscaler demand forecasts.

    ``assist=False`` is shadow mode: the hooks train, the engine never
    consults the model (bit-identity pinned).

    ``device`` (default ``"cuda"``; raises without CUDA unless ``"cpu"``)
    is where every batched forward runs: ``ops.predict_mlp`` launches the
    hand-written kernel on a CUDA device and the plain torch version on the
    CPU.  The weights live in numpy and are trained there; the device holds
    a copy, uploaded again whenever the MLP's update count has moved since
    the last upload (once per ``train_steps`` step).
    """

    def __init__(self, *, assist: bool = True,
                 quantiles: tuple[float, float] = (0.5, 0.9),
                 hidden: tuple[int, int] = (24, 12), lr: float = 0.05,
                 seed: int = 0, overrun: OverrunPolicy | None = None,
                 device: torch.device | str | None = None, window: int = 512,
                 max_cached: int = 262_144):
        self.assist = bool(assist)
        self.mlp = QuantileMLP(PREDICT_FEATURES, hidden, quantiles,
                               lr=lr, seed=seed)
        self.baseline = RunningMeanBaseline()
        self.overrun = overrun if overrun is not None else OverrunPolicy()
        self.device = _resolve_device(device, owner="RuntimePredictor")
        #: device copy of ``mlp.params`` and the ``mlp.updates`` it holds
        self._dev_params: dict[str, torch.Tensor] | None = None
        self._dev_updates = -1
        self.engine = None
        self.train_steps = 0
        self.max_cached = int(max_cached)
        self._cache: dict[int, np.ndarray] = {}   # job_id -> feature row
        #: per-(user, gpus-bucket) running mean of log(actual / declared
        #: est) — the systematic cohort bias folded into the anchor
        self._bias_sum: dict[tuple[int, int], float] = {}
        self._bias_n: dict[tuple[int, int], int] = {}
        self._err_mlp: deque[float] = deque(maxlen=window)
        self._err_base: deque[float] = deque(maxlen=window)
        self._sum_err_mlp = 0.0
        self._sum_err_base = 0.0
        self._n_err = 0
        #: reservation-slack samples (t_res - predicted finish) at backfill
        #: commit time; ``reservations`` is the cumulative count so metric
        #: observers can consume only the new tail (``recent_slacks``)
        self.reservation_slacks: deque[float] = deque(maxlen=4096)
        self.reservations = 0
        self._ctx = np.zeros(NUM_CONTEXT, np.float32)
        self._ctx_key: tuple | None = None

    # ------------------------------------------------------------ plumbing --
    def bind(self, engine) -> None:
        """Attach the engine whose cluster state feeds feature rows.  The
        engine calls this from its constructor (and again on
        ``load_state``); the back-reference is dropped for pickling."""
        self.engine = engine

    def __getstate__(self):
        state = self.__dict__.copy()
        state["engine"] = None          # rebound by SchedulerEngine.load_state
        state["_dev_params"] = None     # uploaded afresh at the first forward
        state["_dev_updates"] = -1
        return state

    def _context(self, engine) -> np.ndarray:
        """4 cluster-context features, memoized per (cluster version,
        queue/running population) so batch scoring pays for it once."""
        cluster = engine.cluster
        key = (getattr(cluster, "version", -1), len(engine.pending),
               len(engine.running), engine.now)
        if key == self._ctx_key:
            return self._ctx
        free, _ = cluster.free_gpu_tallies()
        total, _ = cluster.provisioned_gpu_totals()
        npend, nrun = len(engine.pending), len(engine.running)
        self._ctx = np.array([
            cluster.utilization(up_only=True),
            npend / (npend + 32.0),
            nrun / (nrun + 32.0),
            free / max(total, 1),
        ], np.float32)
        self._ctx_key = key
        return self._ctx

    def _job_row(self, job: Job, engine, now: float) -> np.ndarray:
        if engine is not None:
            return build_features([job], engine.cluster, now,
                                  use_estimates=True)[0]
        return np.zeros(NUM_FEATURES, np.float32)

    def _anchor(self, job: Job) -> float:
        est = float(job.est_runtime)
        if not math.isfinite(est) or est <= 0.0:
            # unknown-duration jobs (see trace.load_trace_csv) are served
            # entirely by the learned model via the baseline anchor (which
            # is already an observed-runtime mean — no debias on top)
            return max(self.baseline.predict(job), 1.0)
        key = (job.user, _gpu_bucket(job.num_gpus))
        n = self._bias_n.get(key, 0)
        if n:
            b = self._bias_sum[key] / n
            est *= math.exp(min(max(b, -RESID_CLAMP), RESID_CLAMP))
        return max(est, 1.0)

    def _rows(self, jobs: list[Job], engine) -> np.ndarray:
        X = np.empty((len(jobs), PREDICT_FEATURES), np.float32)
        cache = self._cache
        missing: list[int] = []
        for k, j in enumerate(jobs):
            row = cache.get(j.job_id)
            if row is None:
                missing.append(k)
            else:
                X[k, :NUM_FEATURES] = row
        if missing:
            if engine is not None:
                feats = build_features([jobs[k] for k in missing],
                                       engine.cluster, engine.now,
                                       use_estimates=True)
            else:       # unbound (offline scoring): zero rows, est anchor
                feats = np.zeros((len(missing), NUM_FEATURES), np.float32)
            for m, k in enumerate(missing):
                X[k, :NUM_FEATURES] = feats[m]
        X[:, NUM_FEATURES:] = (self._context(engine) if engine is not None
                               else self._ctx)
        return X

    def _device_params(self) -> dict[str, torch.Tensor]:
        """The MLP's weights on ``self.device``, copied (never aliased) and
        re-uploaded whenever ``mlp.updates`` has moved."""
        if self._dev_params is None or self._dev_updates != self.mlp.updates:
            self._dev_params = {
                k: torch.tensor(v, dtype=torch.float32, device=self.device)
                for k, v in self.mlp.params.items()}
            self._dev_updates = self.mlp.updates
        return self._dev_params

    def _forward(self, X: np.ndarray) -> np.ndarray:
        """(n, F) float32 rows -> (n, Q) residuals, through
        ``ops.predict_mlp`` on ``self.device``."""
        params = self._device_params()
        with torch.no_grad():
            out = ops.predict_mlp(torch.from_numpy(X).to(self.device), params)
        return out.cpu().numpy()

    # ---------------------------------------------------------- prediction --
    def predict_quantiles(self, jobs: list[Job],
                          engine=None) -> tuple[np.ndarray, np.ndarray]:
        """Batched (p50, p90) runtime predictions in seconds, each
        ``>= 1.0`` with ``p90 >= p50`` enforced."""
        engine = engine if engine is not None else self.engine
        n = len(jobs)
        if n == 0:
            return np.zeros(0), np.zeros(0)
        anchors = np.array([self._anchor(j) for j in jobs], np.float64)
        r = self._forward(self._rows(jobs, engine)).astype(np.float64)
        r = np.clip(r, -RESID_CLAMP, RESID_CLAMP)
        p50 = np.maximum(anchors * np.exp(r[:, 0]), 1.0)
        p90 = np.maximum(anchors * np.exp(r[:, 1]), p50)
        return p50, p90

    def reserve_batch(self, jobs: list[Job], engine=None) -> np.ndarray:
        """p90 reservations for a backfill window (conservative gate)."""
        return self.predict_quantiles(jobs, engine)[1]

    def reserve_runtime(self, job: Job, engine=None) -> float:
        return float(self.reserve_batch([job], engine)[0])

    def predict_runtime(self, job: Job, engine=None) -> float:
        return float(self.predict_quantiles([job], engine)[0][0])

    def lookahead_durations(self, jobs: list[Job], engine=None) -> list[float]:
        """p50 durations for the MILP lookahead jobs (replaces the
        declared-duration assumption in ``core.milp``)."""
        return [float(v) for v in self.predict_quantiles(jobs, engine)[0]]

    def pending_gpu_hours(self, engine=None, cap: int = 512) -> float:
        """Predicted GPU-hours queued in the pending window — the demand
        forecast the autoscaler hysteresis controllers consume.  Windows
        deeper than ``cap`` are scored on the head and extrapolated."""
        engine = engine if engine is not None else self.engine
        pending = engine.pending
        if not pending:
            return 0.0
        window = pending[:cap]
        p50, _ = self.predict_quantiles(window, engine)
        gh = float(np.dot([j.num_gpus for j in window], p50)) / 3600.0
        if len(pending) > len(window):
            gh *= len(pending) / len(window)
        return gh

    # ------------------------------------------------------------- training --
    def on_submit(self, job: Job, now: float) -> None:
        if len(self._cache) >= self.max_cached:
            self._cache.pop(next(iter(self._cache)))
        self._cache[job.job_id] = self._job_row(job, self.engine, now)

    def on_finish(self, job: Job, now: float) -> None:
        actual = max(float(job.runtime), 1.0)
        anchor = self._anchor(job)
        row = self._cache.pop(job.job_id, None)
        if row is None:
            row = self._job_row(job, self.engine, now)
        x = np.empty(PREDICT_FEATURES, np.float32)
        x[:NUM_FEATURES] = row
        x[NUM_FEATURES:] = (self._context(self.engine)
                            if self.engine is not None else self._ctx)
        # prequential errors: predict with the *current* model, then update
        r = float(np.clip(self.mlp.forward(x[None, :])[0, 0],
                          -RESID_CLAMP, RESID_CLAMP))
        p50 = max(anchor * math.exp(r), 1.0)
        base = max(self.baseline.predict(job), 1.0)
        e_mlp = abs(p50 - actual) / actual
        e_base = abs(base - actual) / actual
        self._err_mlp.append(e_mlp)
        self._err_base.append(e_base)
        self._sum_err_mlp += e_mlp
        self._sum_err_base += e_base
        self._n_err += 1
        y = min(max(math.log(actual / anchor), -RESID_CLAMP), RESID_CLAMP)
        self.mlp.sgd_step(x, y)
        est = float(job.est_runtime)
        if math.isfinite(est) and est > 0.0:
            # cohort bias is measured against the *declared* estimate (the
            # debiased anchor would feed back on itself)
            yb = min(max(math.log(actual / max(est, 1.0)),
                         -RESID_CLAMP), RESID_CLAMP)
            key = (job.user, _gpu_bucket(job.num_gpus))
            self._bias_sum[key] = self._bias_sum.get(key, 0.0) + yb
            self._bias_n[key] = self._bias_n.get(key, 0) + 1
        self.baseline.observe(job, actual)
        self.train_steps += 1

    # ------------------------------------------------------------ reporting --
    def note_reservation(self, slack_s: float) -> None:
        """Engine callback at predictor-gated backfill commit:
        ``slack_s = t_res - (now + p90)`` (how much headroom the
        reservation left)."""
        self.reservations += 1
        self.reservation_slacks.append(float(slack_s))

    def recent_slacks(self, cursor: int) -> tuple[list[float], int]:
        """Slack samples recorded since ``cursor`` (a previous return
        value), oldest first, capped at the ring length."""
        new = self.reservations - cursor
        if new <= 0:
            return [], self.reservations
        avail = min(new, len(self.reservation_slacks))
        return list(self.reservation_slacks)[-avail:], self.reservations

    def rolling_mape(self) -> float:
        """Windowed prequential MAPE of the MLP p50 head (0.0 until the
        first completion — zero-division-safe)."""
        return float(np.mean(self._err_mlp)) if self._err_mlp else 0.0

    def baseline_rolling_mape(self) -> float:
        return float(np.mean(self._err_base)) if self._err_base else 0.0

    def mape(self) -> float:
        """Cumulative prequential MAPE of the MLP p50 head."""
        return self._sum_err_mlp / max(self._n_err, 1)

    def baseline_mape(self) -> float:
        return self._sum_err_base / max(self._n_err, 1)

"""Feature Building Module (FBM) + heuristic feature sampling (Sec. 3.2).

17 features per job are maintained; a heuristic sampler selects 8 for the
Observation Vector (OV) consumed by the actor and 5 core features for the
Critic Vector (CV).  All values are normalized to keep the RL input bounded.

Two construction paths, bit-identical by contract (differential-pinned in
``tests/test_features.py``):

- the retained scalar loop (O(window * 17) Python work per decision) — the
  reference, and the fallback when no field arrays are available;
- a vectorized path over the engine's incrementally-maintained
  ``WindowFields`` views (``fields=...``): all arithmetic features become
  whole-column numpy ops; only the placement-dependent ``ways`` query (one
  memoized call per distinct job *shape*, not per job) and the non-numeric
  gathers (``gpu_type`` strings, CPU/mem requests) stay per-job.  Float
  results are identical because every vector op applies the same IEEE
  operation to the same float64 operands the scalar loop used, in the same
  order, before the single float32 store.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.cluster import ClusterState
from repro_torch.core.prioritizer import WindowFields
from repro_torch.core.types import Job

# canonical feature ordering (17 features total, Table 3)
FEATURE_NAMES: tuple[str, ...] = (
    # visible job features
    "job_id", "user", "req_gpus", "vc", "gpu_type_idx",
    "req_time", "submit_time", "req_cpu", "req_mem",
    # cluster characteristics
    "free_nodes", "can_schedule_now", "num_ways_to_schedule",
    # engineered features
    "dsr", "job_size", "urgency", "future_avail", "cff",
)
NUM_FEATURES = len(FEATURE_NAMES)
OV_SIZE = 8       # actor observation features per job
CV_SIZE = 5       # critic features per job
MAX_QUEUE_SIZE = 256

_IDX = {n: i for i, n in enumerate(FEATURE_NAMES)}

# the five core critic features (submit time, run time, can_schedule_now, ...)
CV_FEATURES = ("submit_time", "req_time", "can_schedule_now", "req_gpus", "urgency")


def _norm(x: float, scale: float) -> float:
    """Squash to [0, 1) with a soft scale (robust to heavy tails)."""
    return float(x / (x + scale)) if x > 0 else 0.0


def build_features(
    jobs: list[Job],
    cluster: ClusterState,
    now: float,
    *,
    use_estimates: bool = False,
    fields: WindowFields | None = None,
) -> np.ndarray:
    """(len(jobs), 17) feature matrix for the current queue at time `now`.

    With ``fields`` (the engine's ``WindowFields`` views, aligned
    index-for-index with ``jobs``) the matrix is built with vectorized
    column ops; otherwise the retained scalar reference loop runs.  Both
    paths are bit-identical (differential-pinned)."""
    if fields is not None and len(jobs) == fields.submit_time.shape[0]:
        return _build_features_vec(jobs, cluster, now, fields,
                                   use_estimates=use_estimates)
    return _build_features_scalar(jobs, cluster, now,
                                  use_estimates=use_estimates)


def _build_features_scalar(
    jobs: list[Job],
    cluster: ClusterState,
    now: float,
    *,
    use_estimates: bool = False,
) -> np.ndarray:
    n = len(jobs)
    out = np.zeros((n, NUM_FEATURES), dtype=np.float32)
    if n == 0:
        return out

    # placeable capacity only: free GPUs on cordoned/retired nodes cannot
    # host anything, and retired capacity is no longer provisioned — the
    # policy state must not overstate supply after an autoscaler scale-down
    # (identical to the raw masks whenever autoscaling never acted)
    placeable = cluster.placeable_mask()
    total_free = float(cluster.free_gpus[placeable].sum())
    free_nodes = int(((cluster.free_gpus == cluster.total_gpus)
                      & placeable).sum())
    total_capacity = max(float(cluster.provisioned_gpu_totals()[0]), 1.0)
    cff = cluster.fragmentation()
    gpu_types = sorted(set(cluster.gpu_types)) + ["any"]
    # total demand pending per type (for future availability Eq. (2))
    queued_demand = sum(j.num_gpus for j in jobs)

    for k, j in enumerate(jobs):
        rt = j.est_runtime if use_estimates else j.runtime
        wait = max(0.0, now - j.submit_time)
        ways = cluster.num_ways_to_schedule(j)

        free_t = cluster.free_gpus_of_type(j.gpu_type)
        # Eq. (1): demand-supply ratio for the requested type, normalized
        dsr = _norm(j.num_gpus / max(free_t, 1), 1.0)
        # Eq. (2): expected free GPUs after placing this job and the rest of
        # the queue's demand, normalized to [-1, 1] by provisioned capacity
        fa = (total_free - j.num_gpus - (queued_demand - j.num_gpus)) \
            / total_capacity
        # job size & urgency
        size = _norm(j.num_gpus * rt, 8.0 * 3600.0 * 8.0)
        urgency = _norm(wait / max(rt, 60.0), 4.0)

        out[k, _IDX["job_id"]] = j.job_id % 1000 / 1000.0
        out[k, _IDX["user"]] = (j.user % 128) / 128.0
        out[k, _IDX["req_gpus"]] = _norm(j.num_gpus, 8.0)
        out[k, _IDX["vc"]] = j.vc / 8.0
        out[k, _IDX["gpu_type_idx"]] = gpu_types.index(j.gpu_type) / max(len(gpu_types), 1)
        out[k, _IDX["req_time"]] = _norm(rt, 8 * 3600.0)
        out[k, _IDX["submit_time"]] = _norm(wait, 3600.0)   # age since submission
        out[k, _IDX["req_cpu"]] = _norm(j.req_cpus, 64.0)
        out[k, _IDX["req_mem"]] = _norm(j.req_mem_gb, 512.0)
        out[k, _IDX["free_nodes"]] = free_nodes / max(len(cluster.gpu_types), 1)
        out[k, _IDX["can_schedule_now"]] = 1.0 if ways > 0 else 0.0
        out[k, _IDX["num_ways_to_schedule"]] = ways / 4.0
        out[k, _IDX["dsr"]] = dsr
        out[k, _IDX["job_size"]] = size
        out[k, _IDX["urgency"]] = urgency
        out[k, _IDX["future_avail"]] = np.clip(fa, -1.0, 1.0)
        out[k, _IDX["cff"]] = cff
    # NaN/inf guard: corrupt trace fields (inf est_runtime, NaN memory)
    # must not poison a whole policy/predictor batch; identity on finite
    # inputs, so well-formed paths are bit-unchanged
    return np.nan_to_num(out, nan=0.0, posinf=1.0, neginf=-1.0)


def _vnorm(x: np.ndarray, scale: float) -> np.ndarray:
    """Vectorized ``_norm``: same IEEE divide where x > 0, exact 0 elsewhere
    (all feature inputs are >= 0, so x + scale never hits zero)."""
    return np.where(x > 0, x / (x + scale), 0.0)


def _build_features_vec(
    jobs: list[Job],
    cluster: ClusterState,
    now: float,
    fields: WindowFields,
    *,
    use_estimates: bool = False,
) -> np.ndarray:
    """Vectorized FBM over the engine's contiguous field arrays.  Scalars
    that the loop recomputed per job (cluster aggregates, queued demand)
    are hoisted; per-job Python work shrinks to the placement-dependent
    ``ways`` query (memoized per distinct job shape) and the non-numeric
    gathers (``gpu_type``, CPU/mem requests) the field views don't carry."""
    n = len(jobs)
    out = np.zeros((n, NUM_FEATURES), dtype=np.float32)
    if n == 0:
        return out

    # same placeable/provisioned capacity view as the scalar reference
    placeable = cluster.placeable_mask()
    total_free = float(cluster.free_gpus[placeable].sum())
    free_nodes = int(((cluster.free_gpus == cluster.total_gpus)
                      & placeable).sum())
    total_capacity = max(float(cluster.provisioned_gpu_totals()[0]), 1.0)
    cff = cluster.fragmentation()
    gpu_types = sorted(set(cluster.gpu_types)) + ["any"]
    tindex = {t: i for i, t in enumerate(gpu_types)}
    # the scalar loop sums python ints; fields carry exact integer-valued
    # float64, so the float sum is the same value converted
    queued_demand = float(fields.num_gpus.sum())

    rt = fields.est_runtime if use_estimates else fields.runtime
    gpus = fields.num_gpus
    wait = np.maximum(0.0, now - fields.submit_time)

    # per-job placement queries: one memoized call per distinct shape
    jt = [j.gpu_type for j in jobs]
    ways = np.empty(n, dtype=np.float64)
    shape_ways: dict[tuple, int] = {}
    for k, j in enumerate(jobs):
        key = (j.num_gpus, j.gpu_type, j.req_cpus, j.req_mem_gb)
        w = shape_ways.get(key)
        if w is None:
            w = cluster.num_ways_to_schedule(j)
            shape_ways[key] = w
        ways[k] = w
    free_t_map = {t: cluster.free_gpus_of_type(t) for t in set(jt)}
    free_t = np.array([free_t_map[t] for t in jt], dtype=np.float64)
    type_idx = np.array([tindex[t] for t in jt], dtype=np.float64)
    req_cpus = np.array([j.req_cpus for j in jobs], dtype=np.float64)
    req_mem = np.array([j.req_mem_gb for j in jobs], dtype=np.float64)
    job_ids = np.array([j.job_id for j in jobs], dtype=np.float64)

    fa = (total_free - gpus - (queued_demand - gpus)) / total_capacity

    out[:, _IDX["job_id"]] = np.mod(job_ids, 1000.0) / 1000.0
    out[:, _IDX["user"]] = np.mod(fields.user, 128.0) / 128.0
    out[:, _IDX["req_gpus"]] = _vnorm(gpus, 8.0)
    out[:, _IDX["vc"]] = fields.vc / 8.0
    out[:, _IDX["gpu_type_idx"]] = type_idx / max(len(gpu_types), 1)
    out[:, _IDX["req_time"]] = _vnorm(rt, 8 * 3600.0)
    out[:, _IDX["submit_time"]] = _vnorm(wait, 3600.0)
    out[:, _IDX["req_cpu"]] = _vnorm(req_cpus, 64.0)
    out[:, _IDX["req_mem"]] = _vnorm(req_mem, 512.0)
    out[:, _IDX["free_nodes"]] = free_nodes / max(len(cluster.gpu_types), 1)
    out[:, _IDX["can_schedule_now"]] = (ways > 0).astype(np.float32)
    out[:, _IDX["num_ways_to_schedule"]] = ways / 4.0
    out[:, _IDX["dsr"]] = _vnorm(gpus / np.maximum(free_t, 1.0), 1.0)
    out[:, _IDX["job_size"]] = _vnorm(gpus * rt, 8.0 * 3600.0 * 8.0)
    out[:, _IDX["urgency"]] = _vnorm(wait / np.maximum(rt, 60.0), 4.0)
    out[:, _IDX["future_avail"]] = np.clip(fa, -1.0, 1.0)
    out[:, _IDX["cff"]] = cff
    # same NaN/inf guard as the scalar reference (identity on finite values)
    return np.nan_to_num(out, nan=0.0, posinf=1.0, neginf=-1.0)


def sample_features(feats: np.ndarray, cluster: ClusterState) -> tuple[np.ndarray, list[str]]:
    """Heuristic feature sampling: pick the 8 most situationally relevant
    features (Sec. 3.2).  Returns (n, 8) OV plus the chosen feature names.

    - high fragmentation  -> weight job_size (short jobs fill fragmented nodes)
    - low fragmentation   -> weight urgency (boost aged jobs)
    - flexible placements -> weight num_ways_to_schedule
    """
    cff = cluster.fragmentation()
    base = ["req_gpus", "req_time", "submit_time", "can_schedule_now",
            "dsr", "future_avail"]
    if cff > 0.5:
        chosen = base + ["job_size", "num_ways_to_schedule"]
        weights = {"job_size": 1.5, "num_ways_to_schedule": 1.25}
    else:
        chosen = base + ["urgency", "num_ways_to_schedule"]
        weights = {"urgency": 1.5, "num_ways_to_schedule": 1.25}
    idx = [_IDX[n] for n in chosen]
    ov = feats[:, idx].copy()
    for j, name in enumerate(chosen):
        ov[:, j] *= weights.get(name, 1.0)
    return ov.astype(np.float32), chosen


def critic_features(feats: np.ndarray) -> np.ndarray:
    """(n, 5) critic vector (submit time, run time, can_schedule_now, ...)."""
    idx = [_IDX[n] for n in CV_FEATURES]
    return feats[:, idx].astype(np.float32)


def pad_to_queue(x: np.ndarray, width: int, max_queue: int = MAX_QUEUE_SIZE) -> np.ndarray:
    """Zero-pad (n, width) -> (max_queue, width); truncates overflow."""
    out = np.zeros((max_queue, width), dtype=np.float32)
    n = min(x.shape[0], max_queue)
    if n:
        out[:n] = x[:n]
    return out


def build_state(
    jobs: list[Job],
    cluster: ClusterState,
    now: float,
    *,
    use_estimates: bool = False,
    raw: bool = False,
    fields: WindowFields | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full state construction: returns (OV [256,8], CV [256,5], mask [256]).

    raw=True is the naive-RLTune ablation: the first 8 raw trace features are
    used directly with no engineering or sampling (Fig. 10).  ``fields``
    selects the vectorized FBM over engine-maintained field arrays
    (bit-identical to the scalar loop).
    """
    feats = build_features(jobs, cluster, now, use_estimates=use_estimates,
                           fields=fields)
    if raw:
        ov = feats[:, :OV_SIZE]
    else:
        ov, _ = sample_features(feats, cluster)
    cv = critic_features(feats)
    mask = np.zeros((MAX_QUEUE_SIZE,), dtype=np.float32)
    mask[:min(len(jobs), MAX_QUEUE_SIZE)] = 1.0
    return pad_to_queue(ov, OV_SIZE), pad_to_queue(cv, CV_SIZE), mask

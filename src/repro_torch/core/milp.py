"""MILP-based allocation optimization (Algorithm 1 of the paper).

A binary variable `x` selects way1 (spreading) vs way2 (packing) for the head
job; a boolean occupancy matrix `CJO` (node x GPU-slot) is constrained by
per-node GPU/CPU/memory capacity; the objective maximizes total GPU occupancy.
Look-ahead: the top-K prioritized queue jobs are modeled as extra integer
allocation layers so the spread-vs-pack choice accounts for upcoming demand
(Sec. 3.2 "current and future job requirements ... across multiple time slots").

The paper uses CVXPY + GLPK_MI; this package has no GLPK dependency, so we solve the
identical formulation with `scipy.optimize.milp` (HiGHS, also exact MI).  A
greedy fragmentation-aware fallback handles solver absence/failure.

Constraint-skeleton memoization
-------------------------------
For a fixed ``(n_nodes, gpn, K)`` the *structure* of the capacity and gang
constraint rows, the variable bounds, the integrality vector, and the
objective template never change between calls — only a handful of values do
(per-node free resources, per-job CPU/mem-per-GPU coefficients, look-ahead
GPU demands).  ``_Skeleton`` preallocates those arrays once per key and
every solve fills the changing entries **in place** instead of rebuilding
dense matrices row by row; only the (small, way-dependent) Algorithm-1
equality block is constructed per call and concatenated in front.  Row
ordering is preserved exactly, so the solver sees the same problem as the
per-call builder (retained as ``_solve_milp_reference`` for the
differential equivalence test); construction cost drops ~2x and the full
solve ~15-20% on helios-sized clusters with K=8 look-ahead.

Skeletons are held per *thread* (``_SKELETONS`` is a ``threading.local``
store with a dict surface): parallel federation stepping solves MILPs from
worker threads concurrently, and the skeleton arrays are filled in place
per solve, so sharing one across threads would race.

Solution cache
--------------
``choose_allocation`` additionally memoizes the full result per
``(job shape, candidate ways, look-ahead shapes, use_solver)`` key at the
current ``(cluster.version, cluster.topo_version)``.  Everything the solve
reads — free resources, eligibility masks, the ways themselves — is a pure
function of shape and version, so a hit is exact; any cluster mutation
bumps the version and drops the whole cache (see
``tests/test_milp.py::test_solution_cache_invalidation``).  Within one
rescan window over a deep queue, repeated job shapes then skip the solver
entirely; ``solution_cache=False`` restores the uncached reference path
(differential-pinned).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

try:  # pragma: no cover - import guard
    from scipy.optimize import Bounds, LinearConstraint, milp
    _HAVE_SCIPY = True
except Exception:  # pragma: no cover
    _HAVE_SCIPY = False

from repro_torch.core.cluster import ClusterState, Placement, _job_shape
from repro_torch.core.types import Job


@dataclasses.dataclass
class MILPResult:
    placement: Placement
    way_index: int            # 0 = way1 (spread), 1 = way2 (pack)
    objective: float
    used_solver: bool
    lookahead_scheduled: int  # how many look-ahead jobs the solution also fits


def _slot_ranges(ways: list[Placement]) -> list[dict[int, tuple[int, int]]]:
    """Assign disjoint symbolic slot ranges per node for each way so the
    equality constraints of Algorithm 1 never collide on shared nodes."""
    offset: dict[int, int] = {}
    ranges: list[dict[int, tuple[int, int]]] = []
    for way in ways:
        r: dict[int, tuple[int, int]] = {}
        for node, cnt in way.items():
            s = offset.get(node, 0)
            r[node] = (s, s + cnt)
            offset[node] = s + cnt
        ranges.append(r)
    return ranges


def _lookahead_weights(lookahead: list[Job],
                       durations: list[float] | None) -> list[float] | None:
    """Objective weights from predicted look-ahead durations: the decayed
    credit for fitting look-ahead job k scales with its predicted GPU-time
    (hours, clamped to [0.1, 8] so one wild prediction cannot dominate the
    occupancy terms).  ``None`` (no predictor) keeps the declared-duration
    assumption — the exact pre-prediction coefficients.  Weights are
    rounded so the solution cache keys on the same values the solver
    reads."""
    if durations is None or not lookahead:
        return None
    out = []
    for k in range(len(lookahead)):
        d = durations[k] if k < len(durations) else 3600.0
        out.append(round(min(max(d / 3600.0, 0.1), 8.0), 4))
    return out


def choose_allocation(
    cluster: ClusterState,
    job: Job,
    ways: list[Placement],
    lookahead: list[Job] | None = None,
    *,
    lookahead_k: int = 8,
    use_solver: bool = True,
    solution_cache: bool = True,
    durations: list[float] | None = None,
) -> MILPResult:
    """Pick the best of `ways` for `job` under multi-resource + look-ahead MILP.

    `ways` must be non-empty feasible placements (way1=spread first, way2=pack).

    ``durations`` (optional, aligned with ``lookahead``) are predicted
    runtimes replacing the declared-duration assumption in the look-ahead
    objective terms (see ``_lookahead_weights``); ``None`` is bit-identical
    to the pre-prediction solver.

    With ``solution_cache`` (default) the result is memoized on the cluster
    instance keyed by (job shape, ways, look-ahead shapes, duration
    weights) at the current cluster version — exact, since every input the
    solve reads is a pure function of those; any mutation bumps the
    version and invalidates.
    """
    assert ways, "choose_allocation requires at least one candidate way"
    if len(ways) == 1:
        return MILPResult(ways[0], 0, float(job.num_gpus), False, 0)
    ways = ways[:2]  # Algorithm 1 is binary: way1 vs way2
    lookahead = (lookahead or [])[:lookahead_k]
    weights = _lookahead_weights(lookahead, durations)

    cache = key = None
    if solution_cache:
        ver = (cluster.version, cluster.topo_version)
        store = getattr(cluster, "_milp_sol_cache", None)
        if store is None or store[0] != ver:
            store = (ver, {})
            cluster._milp_sol_cache = store
        cache = store[1]
        key = (_job_shape(job),
               tuple(tuple(sorted(w.items())) for w in ways),
               tuple(_job_shape(lj) for lj in lookahead),
               use_solver,
               None if weights is None else tuple(weights))
        hit = cache.get(key)
        if hit is not None:
            return hit

    if use_solver and _HAVE_SCIPY:
        res = _solve_milp(cluster, job, ways, lookahead, weights)
    else:
        res = None
    if res is None:
        res = _greedy_choice(cluster, job, ways, lookahead, weights)
    if cache is not None:
        cache[key] = res
    return res


# ---------------------------------------------------------------------- solver ---


class _Skeleton:
    """Preallocated constraint structure for one ``(n_nodes, gpn, K)`` key.

    Variable layout (same as the reference builder):
    ``[x | CJO (n_nodes*gpn) | y (K*n_nodes) | z (K)]``.  ``A_fixed`` holds
    the per-node capacity triples (GPU/CPU/mem, rows ``3i..3i+2``) followed
    by the K gang rows; constant coefficients (the GPU-row ones, the gang
    y-sums) are written once here, per-call values are filled in place via
    precomputed flat index arrays before every solve.
    """

    __slots__ = ("n_nodes", "gpn", "K", "n_cjo", "nvar", "A_fixed",
                 "row_lb", "row_ub", "lb", "ub", "integrality", "c",
                 "cpu_cjo_idx", "mem_cjo_idx", "cpu_y_idx", "mem_y_idx",
                 "y0", "z0")

    def __init__(self, n_nodes: int, gpn: int, K: int):
        self.n_nodes, self.gpn, self.K = n_nodes, gpn, K
        self.n_cjo = n_nodes * gpn
        self.nvar = 1 + self.n_cjo + K * n_nodes + K
        self.y0 = 1 + self.n_cjo                 # first y variable
        self.z0 = 1 + self.n_cjo + K * n_nodes   # first z variable
        nvar = self.nvar
        A = np.zeros((3 * n_nodes + K, nvar))
        cpu_cjo, mem_cjo = [], []
        cpu_y = [[] for _ in range(K)]
        mem_y = [[] for _ in range(K)]
        for i in range(n_nodes):
            cols = np.arange(1 + i * gpn, 1 + (i + 1) * gpn)
            A[3 * i, cols] = 1.0                           # GPU row: constant
            cpu_cjo.extend(((3 * i + 1) * nvar + cols).tolist())
            mem_cjo.extend(((3 * i + 2) * nvar + cols).tolist())
            for k in range(K):
                yc = self.y0 + k * n_nodes + i
                A[3 * i, yc] = 1.0                         # GPU row: constant
                cpu_y[k].append((3 * i + 1) * nvar + yc)
                mem_y[k].append((3 * i + 2) * nvar + yc)
        for k in range(K):                                 # gang rows
            r = 3 * n_nodes + k
            A[r, self.y0 + k * n_nodes: self.y0 + (k + 1) * n_nodes] = 1.0
        self.A_fixed = A
        self.cpu_cjo_idx = np.asarray(cpu_cjo, dtype=np.intp)
        self.mem_cjo_idx = np.asarray(mem_cjo, dtype=np.intp)
        self.cpu_y_idx = [np.asarray(ix, dtype=np.intp) for ix in cpu_y]
        self.mem_y_idx = [np.asarray(ix, dtype=np.intp) for ix in mem_y]
        self.row_lb = np.zeros(3 * n_nodes + K)            # all rows lo = 0
        self.row_ub = np.zeros(3 * n_nodes + K)            # capacity filled
        self.lb = np.zeros(nvar)
        self.ub = np.ones(nvar)
        self.integrality = np.ones(nvar)
        self.c = np.zeros(nvar)
        self.c[1:1 + self.n_cjo] = -1.0


class _SkeletonStore(threading.local):
    """Per-thread skeleton memo with a dict surface.  Skeleton arrays are
    filled in place on every solve, so a store shared across the parallel
    federation's worker threads would race; ``threading.local`` gives each
    thread its own dict (built lazily on first access) while ``len`` /
    ``get`` / item assignment keep working for existing callers."""

    def __init__(self):
        self.d: dict[tuple[int, int, int], _Skeleton] = {}

    def __len__(self) -> int:
        return len(self.d)

    def get(self, key):
        return self.d.get(key)

    def __setitem__(self, key, sk) -> None:
        self.d[key] = sk


_SKELETONS = _SkeletonStore()


def _skeleton(n_nodes: int, gpn: int, K: int) -> _Skeleton:
    key = (n_nodes, gpn, K)
    sk = _SKELETONS.get(key)
    if sk is None:
        sk = _SKELETONS[key] = _Skeleton(n_nodes, gpn, K)
    return sk


def _equality_block(sk: _Skeleton, ways: list[Placement]):
    """Algorithm-1 equality rows (way slots tied to 1-x / x) — the only
    way-dependent block, built per call; a handful of rows at most."""
    rows, lbs, ubs = [], [], []
    ranges = _slot_ranges(ways)
    for w, (way, val_is_x) in enumerate(zip(ways, (False, True))):
        for node, (s, e) in ranges[w].items():
            for g in range(s, min(e, sk.gpn)):
                row = np.zeros(sk.nvar)
                row[1 + node * sk.gpn + g] = 1.0
                if val_is_x:   # CJO == x      -> CJO - x == 0
                    row[0] = -1.0
                    lbs.append(0.0)
                    ubs.append(0.0)
                else:          # CJO == 1 - x  -> CJO + x == 1
                    row[0] = 1.0
                    lbs.append(1.0)
                    ubs.append(1.0)
                rows.append(row)
    return np.vstack(rows), np.asarray(lbs), np.asarray(ubs)


def _solve_milp(
    cluster: ClusterState,
    job: Job,
    ways: list[Placement],
    lookahead: list[Job],
    weights: list[float] | None = None,
) -> MILPResult | None:
    n_nodes = len(cluster.gpu_types)
    gpn = int(cluster.total_gpus.max())             # gpus_per_node (slot count)
    K = len(lookahead)
    sk = _skeleton(n_nodes, gpn, K)

    # ---- fill the per-call values in place (every structural nonzero is
    # reassigned each call, so no cross-call zeroing is needed) -------------
    A = sk.A_fixed
    cpu_pg = job.req_cpus / max(job.num_gpus, 1)
    mem_pg = job.req_mem_gb / max(job.num_gpus, 1)
    A.flat[sk.cpu_cjo_idx] = cpu_pg
    A.flat[sk.mem_cjo_idx] = mem_pg
    for k, lj in enumerate(lookahead):
        A.flat[sk.cpu_y_idx[k]] = lj.req_cpus / max(lj.num_gpus, 1)
        A.flat[sk.mem_y_idx[k]] = lj.req_mem_gb / max(lj.num_gpus, 1)
        A[3 * n_nodes + k, sk.z0 + k] = -float(lj.num_gpus)   # gang z coeff
        zc = -(0.5 ** (k + 1)) * lj.num_gpus
        sk.c[sk.z0 + k] = zc if weights is None else zc * weights[k]
        # y are integer GPU counts, bounded by node free GPUs and job demand;
        # nodes_for hits the cluster's topology-versioned eligibility cache
        elig = cluster.nodes_for(lj)
        y0 = sk.y0 + k * n_nodes
        sk.ub[y0:y0 + n_nodes] = np.where(
            elig, np.minimum(cluster.free_gpus, lj.num_gpus), 0)
    # per-node capacity bounds (rows 3i / 3i+1 / 3i+2 = GPU / CPU / mem)
    sk.row_ub[0:3 * n_nodes:3] = cluster.free_gpus
    sk.row_ub[1:3 * n_nodes:3] = cluster.free_cpus
    sk.row_ub[2:3 * n_nodes:3] = cluster.free_mem

    A_eq, eq_lb, eq_ub = _equality_block(sk, ways)
    # one concatenated constraint (equality block first — same row order as
    # the reference); scipy's per-LinearConstraint conversion overhead makes
    # a two-constraint split measurably slower than this single concat
    try:
        res = milp(
            c=sk.c,
            constraints=LinearConstraint(
                np.concatenate([A_eq, A]),
                np.concatenate([eq_lb, sk.row_lb]),
                np.concatenate([eq_ub, sk.row_ub])),
            integrality=sk.integrality,
            bounds=Bounds(sk.lb, sk.ub),
            options={"time_limit": 2.0, "presolve": True},
        )
    except Exception:  # pragma: no cover - solver hiccup
        return None
    if not res.success or res.x is None:
        return None
    x = res.x[0]
    way_index = 1 if x > 0.5 else 0
    z_count = int(round(sum(res.x[sk.z0 + k] for k in range(K)))) if K else 0
    return MILPResult(ways[way_index], way_index, -float(res.fun), True, z_count)


def _solve_milp_reference(
    cluster: ClusterState,
    job: Job,
    ways: list[Placement],
    lookahead: list[Job],
    weights: list[float] | None = None,
) -> MILPResult | None:
    """Per-call dense matrix builder (the pre-memoization implementation),
    retained verbatim as the differential reference for ``_solve_milp``."""
    n_nodes = len(cluster.gpu_types)
    gpn = int(cluster.total_gpus.max())             # gpus_per_node (slot count)
    K = len(lookahead)

    # variable layout: [x | CJO (n_nodes*gpn) | y (K*n_nodes) | z (K)]
    n_cjo = n_nodes * gpn
    nvar = 1 + n_cjo + K * n_nodes + K

    def cjo(i: int, g: int) -> int:
        return 1 + i * gpn + g

    def yvar(k: int, i: int) -> int:
        return 1 + n_cjo + k * n_nodes + i

    def zvar(k: int) -> int:
        return 1 + n_cjo + K * n_nodes + k

    lb = np.zeros(nvar)
    ub = np.ones(nvar)
    integrality = np.ones(nvar)
    for k, lj in enumerate(lookahead):
        elig = cluster.nodes_for(lj)
        y0 = yvar(k, 0)
        ub[y0:y0 + n_nodes] = np.where(
            elig, np.minimum(cluster.free_gpus, lj.num_gpus), 0)

    A_rows, lbs, ubs = [], [], []

    def add(row: np.ndarray, lo: float, hi: float) -> None:
        A_rows.append(row)
        lbs.append(lo)
        ubs.append(hi)

    # Algorithm 1 equality constraints: way slots tied to (1-x) / x
    ranges = _slot_ranges(ways)
    for w, (way, val_is_x) in enumerate(zip(ways, (False, True))):
        for node, (s, e) in ranges[w].items():
            for g in range(s, min(e, gpn)):
                row = np.zeros(nvar)
                row[cjo(node, g)] = 1.0
                if val_is_x:   # CJO == x      -> CJO - x == 0
                    row[0] = -1.0
                    add(row, 0.0, 0.0)
                else:          # CJO == 1 - x  -> CJO + x == 1
                    row[0] = 1.0
                    add(row, 1.0, 1.0)

    cpu_pg = job.req_cpus / max(job.num_gpus, 1)
    mem_pg = job.req_mem_gb / max(job.num_gpus, 1)
    # per-node multi-resource capacity (GPU / CPU / memory)
    for i in range(n_nodes):
        g_row = np.zeros(nvar)
        c_row = np.zeros(nvar)
        m_row = np.zeros(nvar)
        for g in range(gpn):
            g_row[cjo(i, g)] = 1.0
            c_row[cjo(i, g)] = cpu_pg
            m_row[cjo(i, g)] = mem_pg
        for k, lj in enumerate(lookahead):
            g_row[yvar(k, i)] = 1.0
            c_row[yvar(k, i)] = lj.req_cpus / max(lj.num_gpus, 1)
            m_row[yvar(k, i)] = lj.req_mem_gb / max(lj.num_gpus, 1)
        add(g_row, 0.0, float(cluster.free_gpus[i]))
        add(c_row, 0.0, float(cluster.free_cpus[i]))
        add(m_row, 0.0, float(cluster.free_mem[i]))

    # gang constraint for look-ahead jobs: sum_i y[k,i] == req_k * z_k
    for k, lj in enumerate(lookahead):
        row = np.zeros(nvar)
        for i in range(n_nodes):
            row[yvar(k, i)] = 1.0
        row[zvar(k)] = -float(lj.num_gpus)
        add(row, 0.0, 0.0)

    # objective: maximize occupancy + decayed look-ahead placements
    c = np.zeros(nvar)
    c[1:1 + n_cjo] = -1.0
    for k, lj in enumerate(lookahead):
        zc = -(0.5 ** (k + 1)) * lj.num_gpus
        c[zvar(k)] = zc if weights is None else zc * weights[k]

    try:
        res = milp(
            c=c,
            constraints=LinearConstraint(np.vstack(A_rows), np.array(lbs), np.array(ubs)),
            integrality=integrality,
            bounds=Bounds(lb, ub),
            options={"time_limit": 2.0, "presolve": True},
        )
    except Exception:  # pragma: no cover - solver hiccup
        return None
    if not res.success or res.x is None:
        return None
    x = res.x[0]
    way_index = 1 if x > 0.5 else 0
    z_count = int(round(sum(res.x[zvar(k)] for k in range(K)))) if K else 0
    return MILPResult(ways[way_index], way_index, -float(res.fun), True, z_count)


# -------------------------------------------------------------------- fallback ---


def _greedy_choice(
    cluster: ClusterState,
    job: Job,
    ways: list[Placement],
    lookahead: list[Job],
    weights: list[float] | None = None,
) -> MILPResult:
    """Fragmentation-aware heuristic: prefer packing when it leaves larger
    contiguous blocks for upcoming multi-GPU jobs; spread under contention."""
    def score(way: Placement) -> float:
        free_after = cluster.free_gpus.copy()
        for i, g in way.items():
            free_after[i] -= g
        # largest contiguous block preserved + look-ahead satisfiability
        big = float(free_after.max()) if len(free_after) else 0.0
        satisfied = 0.0
        tmp = np.sort(free_after)[::-1].astype(float)
        for k, lj in enumerate(lookahead):
            need = lj.num_gpus
            for ii in range(len(tmp)):
                take = min(tmp[ii], need)
                tmp[ii] -= take
                need -= take
                if need <= 0:
                    credit = 0.5 ** (k + 1)
                    satisfied += credit if weights is None \
                        else credit * weights[k]
                    break
        return big * 0.01 + satisfied

    scores = [score(w) for w in ways]
    idx = int(np.argmax(scores))
    return MILPResult(ways[idx], idx, scores[idx], False, 0)

"""A plain NumPy scheduler with the semantics of the RLTune pass.

It works out again, from the jobs, the cluster, the weights and the state
it is handed, what one event batch does: arrivals and finishes, the 17 job
features and the 8 the actor sees, the actor's logits over the first 256
rows and the same MLP over the rest of the window, the predictor's
quantiles and its online SGD step, the candidate placements (spread, pack,
one node), the binary MILP between the first two (Algorithm 1 with the
look-ahead layers), EASY backfill behind the head's reservation, and the
preemption of a backfilled job that overruns its predicted reservation.
Everything is float64 except the MILP, which is the same formulation
handed to the same solver (scipy's HiGHS): a MILP with several optimal
solutions is only reproducible that way.

``Follower`` runs these passes from a start state and holds each against
the program's record of the same pass.  Where the program reports a value
that the reference can only match to rounding (logits, quantiles), the
reference measures the gap and then goes on with the program's value, so
that a near-tie does not split the two schedules; everything the program
decides from those values (the order, the placements, the start times,
the clock) must then agree exactly.  This module imports nothing of the
program.
"""
from __future__ import annotations

import bisect
import heapq
import math

import numpy as np

MAX_QUEUE = 256
RESID_CLAMP = 4.0
FOLD_EPS = 1e-9
FINISH_EPS = 1e-6
#: logit gaps are taken over the launch's largest reference logit, or over
#: this when that is smaller: the actor's last layer is scaled by 0.01, so
#: its logits are of order 1e-2, and a launch over a few rows can have a
#: largest logit near 0
LOGIT_FLOOR = 1e-3

# the 17 features, in the program's documented order (paper Table 3)
FEATURES = ("job_id", "user", "req_gpus", "vc", "gpu_type_idx", "req_time",
            "submit_time", "req_cpu", "req_mem", "free_nodes",
            "can_schedule_now", "num_ways_to_schedule", "dsr", "job_size",
            "urgency", "future_avail", "cff")
IDX = {n: i for i, n in enumerate(FEATURES)}
OV_BASE = ("req_gpus", "req_time", "submit_time", "can_schedule_now", "dsr",
           "future_avail")


def norm(x, scale):
    """x / (x + scale) where x > 0, else 0 (elementwise)."""
    x = np.asarray(x, dtype=np.float64)
    return np.where(x > 0, x / (x + scale), 0.0)


def mlp(x, layers):
    """tanh MLP over rows: ``layers`` is [(w, b), ...], no tanh after the
    last layer; float64 throughout."""
    h = np.asarray(x, dtype=np.float64)
    for k, (w, b) in enumerate(layers):
        h = h @ w + b
        if k < len(layers) - 1:
            h = np.tanh(h)
    return h


class Jobs:
    """Struct of arrays of the generated jobs, indexed by job id."""

    def __init__(self, arrays: dict):
        self.user = np.asarray(arrays["user"], dtype=np.int64)
        self.submit = np.asarray(arrays["submit_time"], dtype=np.float64)
        self.runtime = np.asarray(arrays["runtime"], dtype=np.float64)
        self.est = np.asarray(arrays["est_runtime"], dtype=np.float64)
        self.gpus = np.asarray(arrays["num_gpus"], dtype=np.int64)
        self.gpu_type = [str(t) for t in arrays["gpu_type"]]
        self.vc = np.asarray(arrays["vc"], dtype=np.int64)
        self.cpus = np.maximum(1, 4 * self.gpus)
        self.mem = 32.0 * self.gpus
        self.n = len(self.submit)

    def shape(self, j: int) -> tuple:
        return (int(self.gpus[j]), self.gpu_type[j], int(self.cpus[j]),
                float(self.mem[j]))


class Cluster:
    """Free GPUs, CPUs and memory per node, and the placement searches."""

    def __init__(self, nodes: list[dict]):
        self.types = [str(n["gpu_type"]) for n in nodes]
        self.total_gpus = np.array([n["gpus"] for n in nodes], dtype=np.int64)
        self.total_cpus = np.array([n["cpus"] for n in nodes], dtype=np.int64)
        self.total_mem = np.array([n["mem_gb"] for n in nodes],
                                  dtype=np.float64)
        self.speed = np.array([n["speed"] for n in nodes], dtype=np.float64)
        self.free_gpus = self.total_gpus.copy()
        self.free_cpus = self.total_cpus.copy()
        self.free_mem = self.total_mem.copy()
        self.type_list = sorted(set(self.types)) + ["any"]
        self.gpn = int(self.total_gpus.max())

    def copy(self) -> "Cluster":
        c = Cluster.__new__(Cluster)
        c.__dict__.update(self.__dict__)
        c.free_gpus = self.free_gpus.copy()
        c.free_cpus = self.free_cpus.copy()
        c.free_mem = self.free_mem.copy()
        return c

    def eligible(self, gpu_type: str) -> np.ndarray:
        if gpu_type == "any":
            return np.ones(len(self.types), dtype=bool)
        return np.array([t == gpu_type for t in self.types])

    def free_of(self, gpu_type: str) -> int:
        return int(self.free_gpus[self.eligible(gpu_type)].sum())

    def fits(self, shape, i: int, g: int) -> bool:
        n, _, cpus, mem = shape
        if g <= 0 or g > self.free_gpus[i]:
            return False
        frac = g / max(n, 1)
        return (self.free_cpus[i] >= round(cpus * frac)
                and self.free_mem[i] >= mem * frac)

    def place(self, shape, mode: str):
        """Greedy gang placement: most-loaded nodes first ('pack') or
        least-loaded first ('spread'); a node's share shrinks until its
        CPUs and memory fit."""
        elig = self.eligible(shape[1])
        key = self.free_gpus if mode == "pack" else -self.free_gpus
        need = shape[0]
        out = {}
        for i in np.argsort(key, kind="stable"):
            i = int(i)
            if not elig[i] or need <= 0:
                continue
            take = int(min(need, self.free_gpus[i]))
            while take > 0 and not self.fits(shape, i, take):
                take -= 1
            if take > 0:
                out[i] = take
                need -= take
        return out if need == 0 else None

    def ways(self, shape) -> list[dict]:
        ways = []
        for mode in ("spread", "pack"):
            p = self.place(shape, mode)
            if p is not None and p not in ways:
                ways.append(p)
        elig = self.eligible(shape[1])
        for i in np.argsort(self.free_gpus, kind="stable"):
            i = int(i)
            if elig[i] and self.fits(shape, i, shape[0]):
                p = {i: shape[0]}
                if p not in ways:
                    ways.append(p)
                break
        return ways

    def take(self, shape, placement: dict, sign: int) -> None:
        for i, g in placement.items():
            frac = g / max(shape[0], 1)
            self.free_gpus[i] -= sign * g
            self.free_cpus[i] -= sign * round(shape[2] * frac)
            self.free_mem[i] -= sign * shape[3] * frac

    def fragmentation(self) -> float:
        tf = float(self.free_gpus.sum())
        if tf <= 0:
            return 0.0
        return 1.0 - float((self.free_gpus.astype(np.float64) ** 2).sum()) \
            / (tf * tf)

    def utilization(self) -> float:
        tot = int(self.total_gpus.sum())
        return float((self.total_gpus - self.free_gpus).sum()) / tot \
            if tot > 0 else 0.0


def features(jobs: Jobs, ids: list[int], cl: Cluster, now: float,
             use_estimates: bool) -> np.ndarray:
    """The (len(ids), 17) feature matrix of a queue at ``now``."""
    ids = np.asarray(ids, dtype=np.int64)
    n = len(ids)
    out = np.zeros((n, len(FEATURES)))
    if n == 0:
        return out
    total_free = float(cl.free_gpus.sum())
    free_nodes = int((cl.free_gpus == cl.total_gpus).sum())
    cap = max(float(cl.total_gpus.sum()), 1.0)
    cff = cl.fragmentation()
    gpus = jobs.gpus[ids].astype(np.float64)
    rt = (jobs.est if use_estimates else jobs.runtime)[ids]
    wait = np.maximum(0.0, now - jobs.submit[ids])
    types = [jobs.gpu_type[j] for j in ids]
    ways_of: dict = {}
    free_of: dict = {}
    ways = np.empty(n)
    free_t = np.empty(n)
    for k, j in enumerate(ids):
        s = jobs.shape(int(j))
        if s not in ways_of:
            ways_of[s] = len(cl.ways(s))
        if s[1] not in free_of:
            free_of[s[1]] = cl.free_of(s[1])
        ways[k] = ways_of[s]
        free_t[k] = free_of[s[1]]
    qd = gpus.sum()
    fa = (total_free - gpus - (qd - gpus)) / cap
    out[:, IDX["job_id"]] = np.mod(ids, 1000) / 1000.0
    out[:, IDX["user"]] = np.mod(jobs.user[ids], 128) / 128.0
    out[:, IDX["req_gpus"]] = norm(gpus, 8.0)
    out[:, IDX["vc"]] = jobs.vc[ids] / 8.0
    out[:, IDX["gpu_type_idx"]] = np.array(
        [cl.type_list.index(t) for t in types]) / len(cl.type_list)
    out[:, IDX["req_time"]] = norm(rt, 8 * 3600.0)
    out[:, IDX["submit_time"]] = norm(wait, 3600.0)
    out[:, IDX["req_cpu"]] = norm(jobs.cpus[ids], 64.0)
    out[:, IDX["req_mem"]] = norm(jobs.mem[ids], 512.0)
    out[:, IDX["free_nodes"]] = free_nodes / len(cl.types)
    out[:, IDX["can_schedule_now"]] = (ways > 0).astype(np.float64)
    out[:, IDX["num_ways_to_schedule"]] = ways / 4.0
    out[:, IDX["dsr"]] = norm(gpus / np.maximum(free_t, 1.0), 1.0)
    out[:, IDX["job_size"]] = norm(gpus * rt, 8.0 * 3600.0 * 8.0)
    out[:, IDX["urgency"]] = norm(wait / np.maximum(rt, 60.0), 4.0)
    out[:, IDX["future_avail"]] = np.clip(fa, -1.0, 1.0)
    out[:, IDX["cff"]] = cff
    return out


def observation(feats: np.ndarray, cff: float) -> np.ndarray:
    """The actor's 8 features: the six base ones, then job size (fragmented
    cluster) or urgency, then the number of ways, the last two weighted."""
    if cff > 0.5:
        names = OV_BASE + ("job_size", "num_ways_to_schedule")
        weights = (1.0,) * 6 + (1.5, 1.25)
    else:
        names = OV_BASE + ("urgency", "num_ways_to_schedule")
        weights = (1.0,) * 6 + (1.5, 1.25)
    return feats[:, [IDX[n] for n in names]] * np.asarray(weights)


# ----------------------------------------------------------------- MILP ----


def milp_choice(cl: Cluster, jobs: Jobs, j: int, ways: list[dict],
                look: list[int], weights):
    """Algorithm 1: x chooses way 1 (spread, x = 0) or way 2 (pack, x = 1);
    a binary occupancy per (node, GPU slot) with the ways' slots tied to
    1 - x and x; integer look-ahead layers y (per job, per node) with a
    binary z per job for the gang; per-node GPU, CPU and memory capacity;
    maximise occupancy plus the decayed look-ahead credit.  Returns the
    chosen way, or None when the solver gives no solution."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    n_nodes, gpn, K = len(cl.types), cl.gpn, len(look)
    n_cjo = n_nodes * gpn
    nvar = 1 + n_cjo + K * n_nodes + K

    def cjo(i, g):
        return 1 + i * gpn + g

    def yv(k, i):
        return 1 + n_cjo + k * n_nodes + i

    def zv(k):
        return 1 + n_cjo + K * n_nodes + k

    lb, ub = np.zeros(nvar), np.ones(nvar)
    for k, lj in enumerate(look):
        elig = cl.eligible(jobs.gpu_type[lj])
        ub[yv(k, 0):yv(k, 0) + n_nodes] = np.where(
            elig, np.minimum(cl.free_gpus, jobs.gpus[lj]), 0)
    rows, lo, hi = [], [], []
    offset: dict = {}
    for w, way in enumerate(ways):
        for node, cnt in way.items():
            s = offset.get(node, 0)
            offset[node] = s + cnt
            for g in range(s, min(s + cnt, gpn)):
                r = np.zeros(nvar)
                r[cjo(node, g)] = 1.0
                r[0] = -1.0 if w == 1 else 1.0
                rows.append(r)
                lo.append(0.0 if w == 1 else 1.0)
                hi.append(0.0 if w == 1 else 1.0)
    n, _, cpus, mem = jobs.shape(j)
    cpu_pg, mem_pg = cpus / max(n, 1), mem / max(n, 1)
    for i in range(n_nodes):
        rg, rc, rm = np.zeros(nvar), np.zeros(nvar), np.zeros(nvar)
        for g in range(gpn):
            rg[cjo(i, g)], rc[cjo(i, g)], rm[cjo(i, g)] = 1.0, cpu_pg, mem_pg
        for k, lj in enumerate(look):
            ln = max(int(jobs.gpus[lj]), 1)
            rg[yv(k, i)] = 1.0
            rc[yv(k, i)] = jobs.cpus[lj] / ln
            rm[yv(k, i)] = jobs.mem[lj] / ln
        for r, cap in ((rg, cl.free_gpus[i]), (rc, cl.free_cpus[i]),
                       (rm, cl.free_mem[i])):
            rows.append(r)
            lo.append(0.0)
            hi.append(float(cap))
    for k, lj in enumerate(look):
        r = np.zeros(nvar)
        r[yv(k, 0):yv(k, 0) + n_nodes] = 1.0
        r[zv(k)] = -float(jobs.gpus[lj])
        rows.append(r)
        lo.append(0.0)
        hi.append(0.0)
    c = np.zeros(nvar)
    c[1:1 + n_cjo] = -1.0
    for k, lj in enumerate(look):
        zc = -(0.5 ** (k + 1)) * int(jobs.gpus[lj])
        c[zv(k)] = zc if weights is None else zc * weights[k]
    try:
        res = milp(c=c, constraints=LinearConstraint(np.vstack(rows),
                                                     np.array(lo),
                                                     np.array(hi)),
                   integrality=np.ones(nvar), bounds=Bounds(lb, ub),
                   options={"time_limit": 2.0, "presolve": True})
    except Exception:  # noqa: BLE001 - a solver error is a missing answer
        return None
    if not res.success or res.x is None:
        return None
    return ways[1] if res.x[0] > 0.5 else ways[0]


def greedy_choice(cl: Cluster, jobs: Jobs, ways: list[dict],
                  look: list[int], weights) -> dict:
    """The fallback without a solver: the way that keeps the largest free
    block and fits the most look-ahead demand."""
    def score(way):
        free = cl.free_gpus.copy()
        for i, g in way.items():
            free[i] -= g
        sat = 0.0
        tmp = np.sort(free)[::-1].astype(float)
        for k, lj in enumerate(look):
            need = int(jobs.gpus[lj])
            for ii in range(len(tmp)):
                t = min(tmp[ii], need)
                tmp[ii] -= t
                need -= t
                if need <= 0:
                    cr = 0.5 ** (k + 1)
                    sat += cr if weights is None else cr * weights[k]
                    break
        return float(free.max()) * 0.01 + sat
    scores = [score(w) for w in ways]
    return ways[int(np.argmax(scores))]


# ------------------------------------------------------------ predictor ----


class Predictor:
    """The runtime predictor's arithmetic: anchor = est * exp(mean cohort
    bias), quantile = anchor * exp(clip(MLP residual, +-4)); each finish
    takes one pinball-loss SGD step and adds log(actual / est) to its
    (user, GPU bucket) cohort."""

    def __init__(self, params: dict, quantiles, lr: float,
                 bias_sum: dict, bias_n: dict, rows: np.ndarray):
        self.p = {k: np.asarray(v, dtype=np.float64) for k, v in params.items()}
        self.taus = np.asarray(quantiles, dtype=np.float64)
        self.lr = float(lr)
        self.bias_sum = dict(bias_sum)
        self.bias_n = dict(bias_n)
        self.rows = rows          # (num_jobs, 17): each job at submission

    @staticmethod
    def cohort(jobs: Jobs, j: int) -> tuple:
        return (int(jobs.user[j]), max(int(jobs.gpus[j]), 0).bit_length())

    def anchor(self, jobs: Jobs, j: int) -> float:
        est = float(jobs.est[j])
        key = self.cohort(jobs, j)
        n = self.bias_n.get(key, 0)
        if n:
            b = self.bias_sum[key] / n
            est *= math.exp(min(max(b, -RESID_CLAMP), RESID_CLAMP))
        return max(est, 1.0)

    def layers(self):
        p = self.p
        return [(p["w1"], p["b1"]), (p["w2"], p["b2"]), (p["w3"], p["b3"])]

    def quantiles(self, jobs: Jobs, ids, ctx: np.ndarray):
        ids = list(ids)
        x = np.concatenate([self.rows[ids],
                            np.broadcast_to(ctx, (len(ids), len(ctx)))], 1)
        r = np.clip(mlp(x, self.layers()), -RESID_CLAMP, RESID_CLAMP)
        a = np.array([self.anchor(jobs, j) for j in ids])
        p50 = np.maximum(a * np.exp(r[:, 0]), 1.0)
        p90 = np.maximum(a * np.exp(r[:, 1]), p50)
        return p50, p90

    def finish(self, jobs: Jobs, j: int, ctx: np.ndarray) -> None:
        actual = max(float(jobs.runtime[j]), 1.0)
        anchor = self.anchor(jobs, j)
        x = np.concatenate([self.rows[j], ctx])
        y = min(max(math.log(actual / anchor), -RESID_CLAMP), RESID_CLAMP)
        p = self.p
        h1 = np.tanh(x @ p["w1"] + p["b1"])
        h2 = np.tanh(h1 @ p["w2"] + p["b2"])
        q = h2 @ p["w3"] + p["b3"]
        g = np.where(q >= y, 1.0 - self.taus, -self.taus)
        dz2 = (p["w3"] @ g) * (1.0 - h2 * h2)
        dz1 = (p["w2"] @ dz2) * (1.0 - h1 * h1)
        lr = self.lr
        p["w3"] -= lr * np.outer(h2, g)
        p["b3"] -= lr * g
        p["w2"] -= lr * np.outer(h1, dz2)
        p["b2"] -= lr * dz2
        p["w1"] -= lr * np.outer(x, dz1)
        p["b1"] -= lr * dz1
        est = float(jobs.est[j])
        if math.isfinite(est) and est > 0.0:
            yb = min(max(math.log(actual / max(est, 1.0)), -RESID_CLAMP),
                     RESID_CLAMP)
            key = self.cohort(jobs, j)
            self.bias_sum[key] = self.bias_sum.get(key, 0.0) + yb
            self.bias_n[key] = self.bias_n.get(key, 0) + 1


def submission_rows(jobs: Jobs, nodes: list[dict], t0: float) -> np.ndarray:
    """Each job's 17 features as the predictor stores them when the whole
    trace is submitted at ``t0`` to an empty cluster: estimates as run
    times, and each job alone in its queue (so its own GPUs are the only
    queued demand in the future-availability feature)."""
    cl = Cluster(nodes)
    out = features(jobs, list(range(jobs.n)), cl, t0, use_estimates=True)
    cap = max(float(cl.total_gpus.sum()), 1.0)
    out[:, IDX["future_avail"]] = np.clip(
        (float(cl.free_gpus.sum()) - jobs.gpus) / cap, -1.0, 1.0)
    return out


# -------------------------------------------------------------- follower ----


def initial_state(jobs: Jobs, nodes: list[dict]) -> dict:
    """The state of a scheduler that has just been handed the whole trace:
    the clock at the first submission, every job an arrival event in
    submission order, nothing pending or running, the cluster empty."""
    cl = Cluster(nodes)
    order = np.argsort(jobs.submit, kind="stable")
    return {"now": float(jobs.submit[order[0]]) if jobs.n else 0.0,
            "pending": [], "running": [],
            "remaining": {int(j): float(jobs.runtime[j])
                          for j in range(jobs.n)},
            "events": [(float(jobs.submit[j]), k, "arrival", int(j))
                       for k, j in enumerate(order)],
            "deadlines": [], "barred": [],
            "free_gpus": cl.free_gpus, "free_cpus": cl.free_cpus,
            "free_mem": cl.free_mem}


class Gaps:
    """What the comparison found: the widest relative logit and quantile
    gaps, counts of exact disagreements, and how many logits were
    compared."""

    def __init__(self):
        self.logit_gap = 0.0
        self.quantile_gap = 0.0
        self.param_gap = 0.0
        self.states = 0
        self.order_faults = 0
        self.schedule_faults = 0
        self.notes: list[str] = []
        self.logits = 0

    def fault(self, kind: str, msg: str) -> None:
        setattr(self, kind, getattr(self, kind) + 1)
        if len(self.notes) < 20:
            self.notes.append(msg)


def rel_gap(got: np.ndarray, want: np.ndarray, floor: float) -> float:
    """max |got - want| over max(max |want|, floor)."""
    if want.size == 0:
        return 0.0
    scale = max(float(np.abs(want).max()), floor)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


def compare_state(want: dict, got: dict, gaps: Gaps, where: str) -> None:
    """Hold the program's state ``got`` against the reference's ``want``:
    the clock, the queue, the running set, the work left, the event heap,
    the reservations and the free capacity exactly; the predictor's
    cohorts exactly and its parameters by ``param_gap``, the widest gap of
    a leaf over the largest magnitude of that leaf or of the median leaf,
    whichever is larger."""
    checks = (
        ("now", float(want["now"]) == float(got["now"])),
        ("pending", list(want["pending"]) == list(got["pending"])),
        ("running", sorted(want["running"]) == sorted(got["running"])),
        ("remaining", dict(want["remaining"]) == dict(got["remaining"])),
        ("events", sorted(want["events"]) == sorted(got["events"])),
        ("deadlines", sorted(want["deadlines"]) == sorted(got["deadlines"])),
        ("barred", sorted(want["barred"]) == sorted(got["barred"])))
    checks += tuple(
        (k, np.array_equal(np.asarray(want[k]), np.asarray(got[k])))
        for k in ("free_gpus", "free_cpus", "free_mem"))
    for name, ok in checks:
        if not ok:
            gaps.fault("schedule_faults", f"{where}: the program's {name} "
                       "differs from the reference's")
    if "predictor" not in want:
        return
    pw, pg = want["predictor"], got.get("predictor")
    if pg is None:
        gaps.fault("schedule_faults", f"{where}: the program has no predictor")
        return
    for name in ("bias_sum", "bias_n"):
        if dict(pw[name]) != dict(pg[name]):
            gaps.fault("schedule_faults", f"{where}: the predictor's "
                       f"{name} differs from the reference's")
    scale = {k: float(np.abs(v).max()) if np.size(v) else 0.0
             for k, v in pw["params"].items()}
    median = float(np.median(list(scale.values())))
    for k, v in pw["params"].items():
        d = np.abs(np.asarray(pg["params"][k], np.float64) - v)
        top, den = (float(d.max()) if d.size else 0.0), max(scale[k], median)
        gap = top / den if den > 0 else (0.0 if top == 0 else math.inf)
        gaps.param_gap = max(gaps.param_gap, gap)
    gaps.states += 1


class Follower:
    """Run the scheduler's passes from a start state, holding each against
    the program's record of that pass (see the module docstring)."""

    def __init__(self, cfg: dict, nodes: list[dict], jobs: Jobs,
                 actor: list, predictor: Predictor | None, state: dict,
                 gaps: Gaps):
        sched = cfg["scheduler"]
        self.window = int(sched["queue_window"])
        self.look_k = int(sched["lookahead_k"])
        self.backfill = bool(sched["backfill"])
        self.deep = bool(sched["deep_scorer"])
        over = (cfg.get("predictor") or {}).get("overrun", {})
        self.grace = float(over.get("grace_s", 60.0))
        self.ckpt = float(over.get("ckpt_interval", 900.0))
        self.penalty = float(over.get("penalty_s", 600.0))
        self.jobs, self.actor, self.pred, self.g = jobs, actor, predictor, gaps
        self.cl = Cluster(nodes)
        self.now = float(state["now"])
        self.pending = [int(j) for j in state["pending"]]
        self.running = {}
        self.remaining = {int(k): float(v)
                          for k, v in state["remaining"].items()}
        self.finish_index = []
        for jid, pl, st, fin, sp in state["running"]:
            pl = {int(i): int(g) for i, g in pl}
            self.running[int(jid)] = (pl, float(st), float(fin), float(sp))
            self.cl.take(jobs.shape(int(jid)), pl, 1)
            bisect.insort(self.finish_index, (float(fin), int(jid)))
        self.events = [(float(t), int(s), str(k), int(j))
                       for t, s, k, j in state["events"]]
        heapq.heapify(self.events)
        self.seq = max([e[1] for e in self.events], default=-1) + 1
        self.deadlines = {int(j): float(t) for j, t in state["deadlines"]}
        self.barred = {int(j) for j in state["barred"]}
        self.check_start(state)

    # ---- the start state, checked by itself ----
    def check_start(self, state: dict) -> None:
        jobs, g = self.jobs, self.g
        for name, mine in (("free_gpus", self.cl.free_gpus),
                           ("free_cpus", self.cl.free_cpus),
                           ("free_mem", self.cl.free_mem)):
            if not np.array_equal(np.asarray(state[name]), mine):
                g.fault("schedule_faults", f"start: {name} is not the "
                        "capacity less the running placements")
        due = {j: t for t, _, k, j in self.events if k == "arrival"}
        for j in range(jobs.n):
            if (j in due and (due[j] != jobs.submit[j] or due[j] < self.now)) \
                    or (j not in due
                        and jobs.submit[j] > self.now + FOLD_EPS):
                g.fault("schedule_faults", f"start: job {j} arrival state")
        keys = [(jobs.submit[j], j) for j in self.pending]
        if keys != sorted(keys) or len(set(self.pending)) != len(keys):
            g.fault("schedule_faults", "start: pending not in arrival order")
        for jid, (pl, st, fin, sp) in self.running.items():
            want_sp = max(min(float(self.cl.speed[i]) for i in pl), 1e-3)
            types = {self.cl.types[i] for i in pl}
            if (sum(pl.values()) != jobs.gpus[jid] or sp != want_sp
                    or abs(fin - (st + self.remaining[jid] / sp)) > FINISH_EPS
                    or (jobs.gpu_type[jid] != "any"
                        and types != {jobs.gpu_type[jid]})):
                g.fault("schedule_faults", f"start: running job {jid}")

    def state(self) -> dict:
        """The reference's state, in the form ``compare_state`` reads."""
        out = {"now": self.now, "pending": list(self.pending),
               "running": [(jid, tuple(sorted(pl.items())), st, fin, sp)
                           for jid, (pl, st, fin, sp) in self.running.items()],
               "remaining": dict(self.remaining),
               "events": list(self.events),
               "deadlines": list(self.deadlines.items()),
               "barred": list(self.barred),
               "free_gpus": self.cl.free_gpus, "free_cpus": self.cl.free_cpus,
               "free_mem": self.cl.free_mem}
        if self.pred is not None:
            out["predictor"] = {"params": self.pred.p,
                                "bias_sum": self.pred.bias_sum,
                                "bias_n": self.pred.bias_n}
        return out

    # ---- one event batch ----
    def ctx(self) -> np.ndarray:
        npend, nrun = len(self.pending), len(self.running)
        free = float(self.cl.free_gpus.sum())
        return np.array([self.cl.utilization(), npend / (npend + 32.0),
                         nrun / (nrun + 32.0),
                         free / max(float(self.cl.total_gpus.sum()), 1.0)])

    def push(self, t: float, kind: str, jid: int) -> None:
        heapq.heappush(self.events, (t, self.seq, kind, jid))
        self.seq += 1

    def push_pending(self, jid: int) -> None:
        key = (self.jobs.submit[jid], jid)
        keys = [(self.jobs.submit[j], j) for j in self.pending]
        self.pending.insert(bisect.bisect_right(keys, key), jid)

    def start(self, jid: int, pl: dict, out: list) -> None:
        self.cl.take(self.jobs.shape(jid), pl, 1)
        sp = max(min(float(self.cl.speed[i]) for i in pl), 1e-3)
        fin = self.now + self.remaining[jid] / sp
        self.running[jid] = (pl, self.now, fin, sp)
        bisect.insort(self.finish_index, (fin, jid))
        self.push(fin, "finish", jid)
        self.pending.remove(jid)
        out.append((jid, tuple(sorted(pl.items())), self.now))

    def stop(self, jid: int) -> tuple:
        pl, st, fin, sp = self.running.pop(jid)
        self.finish_index.remove((fin, jid))
        self.deadlines.pop(jid, None)
        self.cl.take(self.jobs.shape(jid), pl, -1)
        return pl, st, fin, sp

    def step(self, rec: dict) -> None:
        """One event batch, held against the program's record ``rec``:
        ``t`` (clock after the batch), ``starts`` [(job, placement, t)],
        ``decisions`` [(window length, order, [kernel outputs])] and
        ``predictor`` [(kind, values)], each in call order."""
        g = self.g
        if not self.events:
            g.fault("schedule_faults", "reference: no event left")
            return
        now, _, kind, jid = heapq.heappop(self.events)
        self.now = now
        batch = [(kind, jid)]
        while self.events and self.events[0][0] <= now + FOLD_EPS:
            _, _, k2, j2 = heapq.heappop(self.events)
            batch.append((k2, j2))
        for k, j in batch:
            if k == "arrival":
                self.push_pending(j)
            elif j in self.running and \
                    abs(self.running[j][2] - now) < FINISH_EPS:
                self.stop(j)
                if self.pred is not None:
                    self.pred.finish(self.jobs, j, self.ctx())
        self.rec = rec
        self.dec_i = 0
        self.pred_i = 0
        starts: list = []
        if self.deadlines:
            self.enforce()
        self.schedule(starts)
        if rec["t"] != self.now:
            g.fault("schedule_faults", f"pass at t={self.now!r}: the program "
                    f"reads t={rec['t']!r}")
        if starts != list(rec["starts"]):
            g.fault("schedule_faults", f"pass at t={self.now!r}: starts "
                    f"{starts[:3]} against the program's "
                    f"{list(rec['starts'])[:3]}")
        if self.dec_i != len(rec["decisions"]) or \
                self.pred_i != len(rec["predictor"]):
            g.fault("schedule_faults", f"pass at t={self.now!r}: "
                    f"{self.dec_i} decisions and {self.pred_i} predictor calls"
                    f", the program {len(rec['decisions'])} and "
                    f"{len(rec['predictor'])}")

    def enforce(self) -> None:
        """Preempt a predictor-gated backfill that overran its reservation
        (plus grace) while jobs wait; it requeues with its checkpointed
        progress and a restore penalty, and may not backfill again."""
        for jid, deadline in list(self.deadlines.items()):
            if jid not in self.running:
                self.deadlines.pop(jid, None)
                continue
            if self.now <= deadline + self.grace or not self.pending:
                continue
            self.deadlines.pop(jid, None)
            self.barred.add(jid)
            pl, st, fin, sp = self.stop(jid)
            elapsed = max(0.0, self.now - st)
            done = elapsed * sp
            done = min(int(elapsed // self.ckpt) * self.ckpt * sp, done)
            left = max(self.remaining[jid] - done, 1.0) + self.penalty
            self.remaining[jid] = left
            self.push_pending(jid)

    def program_predictor(self, kind: str, want: np.ndarray) -> np.ndarray:
        """The program's next predictor answer, held against ``want``."""
        calls = self.rec["predictor"]
        i = self.pred_i
        self.pred_i += 1
        if i >= len(calls) or calls[i][0] != kind or \
                len(calls[i][1]) != len(want):
            self.g.fault("schedule_faults", f"t={self.now!r}: predictor call "
                         f"{i} is not {kind} over {len(want)} jobs")
            return want
        got = np.asarray(calls[i][1], dtype=np.float64)
        self.g.quantile_gap = max(self.g.quantile_gap,
                                  float((np.abs(got - want) / want).max()))
        return got

    def rank(self, queue: list[int]) -> list[int]:
        """The actor's logits over the window, held against the program's;
        the order must be the program's logits sorted (stable, FIFO among
        ties), head window first, then the tail."""
        g = self.g
        decs = self.rec["decisions"]
        i = self.dec_i
        self.dec_i += 1
        feats = features(self.jobs, queue, self.cl, self.now, False)
        ref = mlp(observation(feats, self.cl.fragmentation()),
                  self.actor)[:, 0]
        n = min(len(queue), MAX_QUEUE)
        if i >= len(decs) or decs[i][0] != len(queue):
            g.fault("order_faults", f"t={self.now!r}: decision {i} over a "
                    f"window of {len(queue)} has no program record to match")
            return list(np.argsort(-ref, kind="stable"))
        _, order, outs = decs[i]
        tail = self.deep and len(queue) > MAX_QUEUE
        if len(outs) != (2 if tail else 1):
            g.fault("order_faults", f"t={self.now!r}: {len(outs)} actor "
                    "launches in one decision")
            return list(order)
        head = np.asarray(outs[-1], dtype=np.float32)
        g.logit_gap = max(g.logit_gap, rel_gap(head[:n], ref[:n], LOGIT_FLOOR))
        g.logits += n
        want = [int(k) for k in np.argsort(-head[:n], kind="stable")]
        if tail:
            t = np.asarray(outs[0], dtype=np.float32)[:len(queue) - n]
            g.logit_gap = max(g.logit_gap, rel_gap(t, ref[n:], LOGIT_FLOOR))
            g.logits += len(t)
            want += [n + int(k) for k in np.argsort(-t, kind="stable")]
        else:
            want += list(range(n, len(queue)))
        if [int(k) for k in order] != want:
            g.fault("order_faults", f"t={self.now!r}: the order is not the "
                    "program's logits sorted")
        return [int(k) for k in order]

    def alloc(self, j: int, look: list[int], durations) -> dict | None:
        ways = self.cl.ways(self.jobs.shape(j))
        if not ways:
            return None
        if len(ways) == 1:
            return ways[0]
        weights = None
        if durations is not None and look:
            weights = [round(min(max(float(d) / 3600.0, 0.1), 8.0), 4)
                       for d in durations[:len(look)]]
        look = look[:self.look_k]
        ch = milp_choice(self.cl, self.jobs, j, ways[:2], look, weights)
        if ch is None:
            ch = greedy_choice(self.cl, self.jobs, ways[:2], look, weights)
        return ch

    def schedulable(self) -> bool:
        if int(self.cl.free_gpus.sum()) == 0:
            return False
        seen: dict = {}
        for j in self.pending[:self.window]:
            s = self.jobs.shape(j)
            if s not in seen:
                seen[s] = (self.cl.free_of(s[1]) >= s[0]
                           and self.cl.place(s, "pack") is not None)
            if seen[s]:
                return True
        return False

    def schedule(self, starts: list) -> None:
        jobs = self.jobs
        while self.pending:
            if not self.schedulable():
                return
            queue = self.pending[:self.window]
            order = self.rank(queue)
            top = queue[order[0]]
            rest = [queue[i] for i in order[1:1 + self.look_k]]
            durations = None
            if self.pred is not None and rest:
                p50, _ = self.pred.quantiles(jobs, rest, self.ctx())
                durations = self.program_predictor("p50", p50)
            pl = self.alloc(top, rest, durations)
            if pl is not None:
                self.start(top, pl, starts)
                continue
            if not self.backfill:
                return
            t_res = self.reservation(top)
            if self.pred is not None:
                _, p90 = self.pred.quantiles(jobs, queue, self.ctx())
                p90 = np.maximum(self.program_predictor("p90", p90), 1.0)
                ok = self.now + p90 <= t_res
                for k, c in enumerate(queue):
                    if c in self.barred:
                        ok[k] = False
            else:
                ok = self.now + np.maximum(jobs.runtime[queue], 1.0) <= t_res
            progressed = False
            dead: set = set()
            for i in order[1:]:
                if not ok[i]:
                    continue
                c = queue[i]
                s = jobs.shape(c)
                if s in dead:
                    continue
                if self.cl.free_of(s[1]) < s[0]:
                    dead.add(s)
                    continue
                cpl = self.alloc(c, [], None)
                if cpl is None:
                    dead.add(s)
                    continue
                self.start(c, cpl, starts)
                progressed = True
                dead = set()
                if self.pred is not None and t_res < math.inf:
                    self.deadlines[c] = t_res
            if not progressed or \
                    self.cl.place(jobs.shape(top), "pack") is None:
                return

    def reservation(self, top: int) -> float:
        """EASY: the earliest instant the head fits, releasing running jobs
        in order of finish."""
        s = self.jobs.shape(top)
        sim = self.cl.copy()
        if sim.place(s, "pack") is not None:
            return self.now
        for fin, jid in self.finish_index:
            sim.take(self.jobs.shape(jid), self.running[jid][0], -1)
            if sim.place(s, "pack") is not None:
                return fin
        return math.inf

"""Baseline scheduling policies (Table 5) + Slurm multifactor + QSSF.

Each policy maps (job, now) -> score; the simulator schedules the job with the
LOWEST score first (RLScheduler convention).  Runtime `rt` uses the user
estimate when `use_estimates=True` (evaluation) and ground truth otherwise.

Every policy also exposes ``score_batch(jobs, now) -> np.ndarray`` scoring a
whole queue window in one call.  The batch path is **bit-identical** to the
scalar ``score`` loop: it vectorizes only the IEEE-exact operations
(add/sub/mul/div/min/max/negate, which round identically in numpy and
CPython) and routes every transcendental through the *same* ``math.*``
libm call as the scalar path, memoized per distinct input (``np.log10`` et
al. are not bit-identical to ``math.log10`` on SIMD builds, and a 1-ulp
score difference can flip an argsort and change the schedule).
"""
from __future__ import annotations

import math
from operator import attrgetter
from typing import Callable, Protocol

import numpy as np

from repro_torch.core.types import Job

ScoreFn = Callable[[Job, float], float]

# C-level field gather: map(attrgetter) + fromiter fills the array without
# a Python-level loop body (the per-decision cost floor of batch scoring)
_GET_SUBMIT = attrgetter("submit_time")
_GET_RUNTIME = attrgetter("runtime")
_GET_EST = attrgetter("est_runtime")
_GET_GPUS = attrgetter("num_gpus")
_GET_VC = attrgetter("vc")


def _farr(jobs: list[Job], getter) -> np.ndarray:
    return np.fromiter(map(getter, jobs), np.float64, count=len(jobs))


class Policy(Protocol):
    name: str

    def score(self, job: Job, now: float) -> float: ...
    def score_batch(self, jobs: list[Job], now: float,
                    fields: "WindowFields | None" = None) -> np.ndarray: ...
    def observe_finish(self, job: Job) -> None: ...


def _rt(job: Job, use_estimates: bool) -> float:
    return max(job.est_runtime if use_estimates else job.runtime, 1.0)


def _rt_arr(jobs: list[Job], use_estimates: bool, fields=None) -> np.ndarray:
    if fields is not None:
        raw = fields.est_runtime if use_estimates else fields.runtime
    else:
        raw = _farr(jobs, _GET_EST if use_estimates else _GET_RUNTIME)
    return np.maximum(raw, 1.0)


class _Memo(dict):
    """Value-keyed libm memo: ``__missing__`` computes once, after which
    ``map(memo.__getitem__, values)`` runs entirely at C level — the same
    jobs are re-ranked every decision, so warm windows never re-enter
    Python per element.  Bounded: continuous-valued keys (runtimes) would
    otherwise grow without limit on indefinite streams, so the memo resets
    once it hits ``limit`` entries (values are recomputed deterministically,
    so a reset never changes results)."""

    __slots__ = ("_fn", "_limit")

    def __init__(self, fn, limit: int = 1 << 20):
        super().__init__()
        self._fn = fn
        self._limit = limit

    def __missing__(self, key):
        if len(self) >= self._limit:
            self.clear()
        v = self._fn(key)
        self[key] = v
        return v


# memoized libm transcendentals (value-keyed => collision-free, amortized to
# one math.* call per distinct input while the same jobs are re-ranked)
_LOG10 = _Memo(math.log10)
_LOG1P = _Memo(math.log1p)
_LOG2_GPUS = _Memo(lambda g: math.log2(max(g, 2)))


class _FnPolicy:
    """Stateless policy from a scalar score function + exact batch variant."""

    def __init__(self, name: str, fn: Callable[[Job, float, bool], float],
                 batch_fn: Callable[[list[Job], float, bool], np.ndarray],
                 use_estimates: bool = False):
        self.name = name
        self._fn = fn
        self._batch_fn = batch_fn
        self.use_estimates = use_estimates

    def score(self, job: Job, now: float) -> float:
        return self._fn(job, now, self.use_estimates)

    def score_batch(self, jobs: list[Job], now: float,
                    fields=None) -> np.ndarray:
        return self._batch_fn(jobs, now, self.use_estimates, fields)

    def observe_finish(self, job: Job) -> None:  # stateless
        pass


def _fcfs(j: Job, now: float, est: bool) -> float:
    return j.submit_time


def _fcfs_batch(jobs: list[Job], now: float, est: bool,
                fields=None) -> np.ndarray:
    if fields is not None:
        return fields.submit_time
    return _farr(jobs, _GET_SUBMIT)


def _sjf(j: Job, now: float, est: bool) -> float:
    return _rt(j, est)


def _sjf_batch(jobs: list[Job], now: float, est: bool,
               fields=None) -> np.ndarray:
    return _rt_arr(jobs, est, fields)


def _wfp3(j: Job, now: float, est: bool) -> float:
    wt = max(0.0, now - j.submit_time)
    rt = _rt(j, est)
    return -((wt / rt) ** 3) * j.num_gpus


def _wfp3_batch(jobs: list[Job], now: float, est: bool,
                fields=None) -> np.ndarray:
    st = fields.submit_time if fields is not None else _farr(jobs, _GET_SUBMIT)
    g = fields.num_gpus if fields is not None else _farr(jobs, _GET_GPUS)
    x = np.maximum(0.0, now - st) / _rt_arr(jobs, est, fields)
    # `x ** 3` must match CPython's pow(x, 3.0); np.power special-cases small
    # integer exponents differently, so cube through the scalar operator
    cube = np.asarray([v ** 3 for v in x.tolist()], dtype=np.float64)
    return -cube * g


def _unicep(j: Job, now: float, est: bool) -> float:
    wt = max(0.0, now - j.submit_time)
    rt = _rt(j, est)
    return -wt / (math.log2(max(j.num_gpus, 2)) * rt)


def _unicep_batch(jobs: list[Job], now: float, est: bool,
                  fields=None) -> np.ndarray:
    if fields is not None:
        st = fields.submit_time
        # float keys hash/compare equal to the scalar path's int keys and
        # produce the same libm value, so the memo stays collision-free
        gpu_keys = fields.num_gpus.tolist()
    else:
        st = _farr(jobs, _GET_SUBMIT)
        gpu_keys = map(_GET_GPUS, jobs)
    lg = np.fromiter(map(_LOG2_GPUS.__getitem__, gpu_keys),
                     np.float64, count=len(jobs))
    wt = np.maximum(0.0, now - st)
    return -wt / (lg * _rt_arr(jobs, est, fields))


def _f1(j: Job, now: float, est: bool) -> float:
    rt = _rt(j, est)
    st = max(j.submit_time, 1.0)
    return math.log10(rt) * j.num_gpus + 870.0 * math.log10(st)


def _f1_batch(jobs: list[Job], now: float, est: bool,
              fields=None) -> np.ndarray:
    n = len(jobs)
    lrt = np.fromiter(
        map(_LOG10.__getitem__, _rt_arr(jobs, est, fields).tolist()),
        np.float64, count=n)
    # np.maximum(st, 1.0) == max(j.submit_time, 1.0) elementwise (exact)
    st = fields.submit_time if fields is not None else _farr(jobs, _GET_SUBMIT)
    sm = np.maximum(st, 1.0)
    lst = np.fromiter(map(_LOG10.__getitem__, sm.tolist()),
                      np.float64, count=n)
    g = fields.num_gpus if fields is not None else _farr(jobs, _GET_GPUS)
    return lrt * g + 870.0 * lst


class SlurmMultifactor:
    """Slurm's multifactor priority plugin, GPU-adapted (Sec. 5.4).

    priority = w_age*age + w_fairshare*fairshare + w_jobsize*jobsize
             + w_partition*partition + w_qos*qos,  all weights = 1000.
    Higher priority first => score = -priority.
    Fairshare maps CPU fair-share math onto GPU-seconds usage with decay.
    """

    name = "slurm-mf"

    def __init__(self, use_estimates: bool = False, half_life: float = 7 * 86400.0):
        self.use_estimates = use_estimates
        self.half_life = half_life
        self._usage: dict[int, float] = {}   # user -> decayed GPU-seconds
        self._last_decay = 0.0
        self.weights = dict(age=1000.0, fairshare=1000.0, jobsize=1000.0,
                            partition=1000.0, qos=1000.0)

    def _decay(self, now: float) -> None:
        dt = now - self._last_decay
        if dt <= 0:
            return
        f = 0.5 ** (dt / self.half_life)
        for u in self._usage:
            self._usage[u] *= f
        self._last_decay = now

    def _fairshare(self, user: int, total: float) -> float:
        share = self._usage.get(user, 0.0) / total
        return 2.0 ** (-share * 8.0)

    def score(self, job: Job, now: float) -> float:
        self._decay(now)
        age = min(max(0.0, now - job.submit_time) / (7 * 86400.0), 1.0)
        total = sum(self._usage.values()) + 1e-9
        fairshare = self._fairshare(job.user, total)   # low usage => high
        rt = _rt(job, self.use_estimates)
        jobsize = 1.0 / (1.0 + math.log1p(rt / 3600.0))  # requested runtime factor
        partition = 1.0 - (job.vc / 10.0)            # per-queue priority
        qos = 1.0
        w = self.weights
        pri = (w["age"] * age + w["fairshare"] * fairshare + w["jobsize"] * jobsize
               + w["partition"] * partition + w["qos"] * qos)
        return -pri

    def score_batch(self, jobs: list[Job], now: float,
                    fields=None) -> np.ndarray:
        self._decay(now)
        n = len(jobs)
        st = fields.submit_time if fields is not None \
            else _farr(jobs, _GET_SUBMIT)
        age = np.minimum(np.maximum(0.0, now - st) / (7 * 86400.0), 1.0)
        total = sum(self._usage.values()) + 1e-9
        # float user keys (engine field arrays) hash/compare equal to the
        # scalar path's int keys, so usage lookups and the per-user memo
        # stay collision-free and bit-identical
        users = fields.user.tolist() if fields is not None \
            else [j.user for j in jobs]
        fs_by_user = {u: self._fairshare(u, total) for u in set(users)}
        fairshare = np.fromiter(map(fs_by_user.__getitem__, users),
                                np.float64, count=n)
        hours = _rt_arr(jobs, self.use_estimates, fields) / 3600.0
        l1p = np.fromiter(map(_LOG1P.__getitem__, hours.tolist()),
                          np.float64, count=n)
        jobsize = 1.0 / (1.0 + l1p)
        vc = fields.vc if fields is not None else _farr(jobs, _GET_VC)
        partition = 1.0 - vc / 10.0
        qos = 1.0
        w = self.weights
        pri = (w["age"] * age + w["fairshare"] * fairshare
               + w["jobsize"] * jobsize + w["partition"] * partition
               + w["qos"] * qos)
        return -pri

    def observe_finish(self, job: Job) -> None:
        self._usage[job.user] = (self._usage.get(job.user, 0.0)
                                 + job.runtime * job.num_gpus)


class QSSF:
    """Quasi-Shortest-Service-First (Helios, Hu et al. '21).

    Service = predicted_runtime * num_gpus; prediction is history-based:
    the rolling mean of the user's past runtimes (cold-start: user estimate).
    """

    name = "qssf"

    def __init__(self, use_estimates: bool = True, window: int = 16):
        self.use_estimates = use_estimates
        self.window = window
        self._hist: dict[int, list[float]] = {}

    def predict_runtime(self, job: Job) -> float:
        h = self._hist.get(job.user)
        if not h:
            return _rt(job, self.use_estimates)
        return sum(h) / len(h)

    def score(self, job: Job, now: float) -> float:
        return self.predict_runtime(job) * job.num_gpus

    def score_batch(self, jobs: list[Job], now: float,
                    fields=None) -> np.ndarray:
        means = {u: sum(h) / len(h) for u, h in self._hist.items() if h}
        if fields is not None:
            # float user keys hash equal to the history's int keys; the
            # cold-start fallback is _rt_arr's elementwise max (== _rt)
            cold = _rt_arr(jobs, self.use_estimates, fields).tolist()
            pred = np.fromiter(
                (means[u] if u in means else c
                 for u, c in zip(fields.user.tolist(), cold)),
                np.float64, count=len(jobs))
        else:
            pred = np.fromiter(
                (means[j.user] if j.user in means
                 else _rt(j, self.use_estimates) for j in jobs),
                np.float64, count=len(jobs))
        g = fields.num_gpus if fields is not None else _farr(jobs, _GET_GPUS)
        return pred * g

    def observe_finish(self, job: Job) -> None:
        h = self._hist.setdefault(job.user, [])
        h.append(job.runtime)
        if len(h) > self.window:
            h.pop(0)


_FNS: dict[str, tuple[Callable[[Job, float, bool], float],
                      Callable[[list[Job], float, bool], np.ndarray]]] = {
    "fcfs": (_fcfs, _fcfs_batch), "fifo": (_fcfs, _fcfs_batch),
    "sjf": (_sjf, _sjf_batch), "wfp3": (_wfp3, _wfp3_batch),
    "unicep": (_unicep, _unicep_batch), "f1": (_f1, _f1_batch),
}


def make_policy(name: str, use_estimates: bool = False) -> Policy:
    name = name.lower()
    if name in _FNS:
        fn, batch_fn = _FNS[name]
        return _FnPolicy(name, fn, batch_fn, use_estimates)
    if name in ("slurm", "slurm-mf", "multifactor"):
        return SlurmMultifactor(use_estimates)
    if name == "qssf":
        return QSSF(use_estimates)
    raise ValueError(f"unknown policy {name!r}")


BASE_POLICIES = ("fcfs", "sjf", "wfp3", "unicep", "f1", "qssf", "slurm-mf")

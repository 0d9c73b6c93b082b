"""The job stream of a cell, made from the seed.

A configuration's ``profile`` gives the trace's statistics (the RLTune
paper's Tables 2 and 4): arrival rate, lognormal run times matched to the
trace's mean, the GPU-demand and GPU-type mixes, a Zipf-like user
population, and a two-state Markov-modulated Poisson process for bursts.
A traffic file scales the arrival rate (``rate_factor``), says how many
jobs to draw, and names the traces by their seeds (``trace_seeds``): they
stand for recorded traces, the same in every run, since each trace puts a
backlog in a regime of its own and a run's work would otherwise change
with its seed.  A run's ``--seed`` changes no job of any trace.  The generator is a copy of the one in the program's trace
module, so that the yardstick cannot move with the program; it draws the
same numbers in the same order (``num_archs`` draws the informational
workload name, which no job field keeps).
"""
from __future__ import annotations

import math

import numpy as np

FIELDS = ("user", "submit_time", "runtime", "est_runtime", "num_gpus",
          "gpu_type", "vc")


def generate(profile: dict, num_jobs: int, seed,
             rate_factor: float = 1.0) -> dict:
    """``num_jobs`` jobs as a dict of arrays (job id = index), submit
    times increasing from the first inter-arrival gap.  ``seed`` is
    anything ``numpy.random.default_rng`` takes."""
    rng = np.random.default_rng(seed)
    demands, dprobs = zip(*profile["gpu_demand"])
    types, tprobs = zip(*profile["gpu_types"])
    dprobs = np.asarray(dprobs, dtype=np.float64) / sum(dprobs)
    tprobs = np.asarray(tprobs, dtype=np.float64) / sum(tprobs)
    sigma = float(profile["runtime_sigma"])
    mu = math.log(float(profile["runtime_mean"])) - 0.5 * sigma * sigma
    users = int(profile["num_users"])
    user_w = 1.0 / np.arange(1, users + 1) ** 1.1
    user_w /= user_w.sum()
    rate0 = float(profile["arrival_rate"]) * float(rate_factor)
    burst = float(profile["burst_factor"])
    p_burst, p_calm = float(profile["burst_prob"]), float(profile["calm_prob"])
    est_sigma = float(profile["est_noise_sigma"])
    max_rt = float(profile["max_runtime"])
    archs = int(profile.get("num_archs", 0))

    out = {k: [] for k in FIELDS}
    t = 0.0
    bursty = False
    for _ in range(int(num_jobs)):
        rate = rate0 * (burst if bursty else 1.0)
        t += float(rng.exponential(1.0 / rate))
        if bursty:
            if rng.random() < p_calm:
                bursty = False
        elif rng.random() < p_burst:
            bursty = True
        runtime = float(np.clip(rng.lognormal(mu, sigma), 30.0, max_rt))
        est = float(np.clip(runtime * rng.lognormal(0.0, est_sigma),
                            30.0, max_rt * 2))
        out["user"].append(int(rng.choice(users, p=user_w)))
        out["submit_time"].append(t)
        out["runtime"].append(runtime)
        out["est_runtime"].append(est)
        out["num_gpus"].append(int(rng.choice(demands, p=dprobs)))
        out["gpu_type"].append(str(rng.choice(types, p=tprobs)))
        out["vc"].append(int(rng.integers(0, 5)))
        if archs:
            rng.choice(archs)
    arrays = {k: np.asarray(v) for k, v in out.items()}
    arrays["gpu_type"] = np.asarray(out["gpu_type"], dtype=object)
    return arrays

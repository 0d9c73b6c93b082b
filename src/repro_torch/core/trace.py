"""Trace generation and loading.

Real Philly / Helios / Alibaba traces are not redistributable, so the default
path is a *statistically matched* synthetic generator per trace (Table 2 and
Table 4 of the paper): arrival rate, runtime scale, GPU-demand mix, user
population, burstiness.  A CSV loader accepts the real traces when available
(columns: job_id,user,submit_time,runtime,num_gpus[,gpu_type][,vc]).

Burstiness is modeled with a 2-state Markov-modulated Poisson process (calm /
burst), matching the paper's observation (Fig. 6) that batch-wise congestion
is highly non-stationary.
"""
from __future__ import annotations

import csv
import dataclasses
import math

import numpy as np

from repro_torch.core.types import ClusterSpec, Job, NodeSpec

# ----------------------------------------------------------------------------------
# Trace profiles (Table 2: arrival rates & runtimes; Table 4: GPU types / clusters)
# ----------------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceProfile:
    name: str
    arrival_rate: float              # jobs/s (Table 2)
    runtime_mean: float              # s (Table 2)
    runtime_sigma: float             # lognormal sigma
    gpu_demand: tuple[tuple[int, float], ...]   # (num_gpus, prob)
    gpu_types: tuple[tuple[str, float], ...]    # (type, request prob); "any" allowed
    num_users: int
    burst_factor: float = 6.0        # arrival-rate multiplier in burst state
    burst_prob: float = 0.08         # P(calm->burst) per arrival
    calm_prob: float = 0.35          # P(burst->calm) per arrival
    est_noise_sigma: float = 0.9     # lognormal noise on user estimates
    max_runtime: float = 60 * 86400.0
    archs: tuple[str, ...] = ()      # workload architectures (informational)


_ARCH_POOL = (
    "internvl2-2b", "mamba2-780m", "qwen3-moe-235b-a22b", "granite-moe-1b-a400m",
    "jamba-v0.1-52b", "nemotron-4-15b", "stablelm-1.6b", "yi-6b",
    "h2o-danube-1.8b", "whisper-tiny",
)

PHILLY = TraceProfile(
    name="philly",
    arrival_rate=0.022333,
    runtime_mean=26299.2,
    runtime_sigma=2.1,
    # Philly: heavy multi-GPU mix, long jobs (ATC'19 analysis)
    gpu_demand=((1, 0.48), (2, 0.17), (4, 0.12), (8, 0.16), (16, 0.05), (32, 0.02)),
    gpu_types=(("P100", 0.75), ("any", 0.25)),
    num_users=319,
    burst_factor=4.0,
    max_runtime=60 * 86400.0,
    archs=_ARCH_POOL,
)

HELIOS = TraceProfile(
    name="helios",
    arrival_rate=0.032919,
    runtime_mean=2481.4,
    runtime_sigma=1.9,
    gpu_demand=((1, 0.60), (2, 0.15), (4, 0.12), (8, 0.11), (16, 0.02)),
    gpu_types=(("V100", 0.55), ("P100", 0.25), ("any", 0.20)),
    num_users=277,
    burst_factor=7.0,
    max_runtime=50 * 86400.0,
    archs=_ARCH_POOL,
)

ALIBABA = TraceProfile(
    name="alibaba",
    arrival_rate=0.077136,
    runtime_mean=5466.3,
    runtime_sigma=2.0,
    gpu_demand=((1, 0.78), (2, 0.12), (4, 0.06), (8, 0.04)),
    gpu_types=(("T4", 0.35), ("P100", 0.15), ("V100", 0.25), ("any", 0.25)),
    num_users=1242,
    burst_factor=8.0,
    max_runtime=30 * 86400.0,
    archs=_ARCH_POOL,
)

PROFILES: dict[str, TraceProfile] = {"philly": PHILLY, "helios": HELIOS, "alibaba": ALIBABA}


# ----------------------------------------------------------------------------------
# Cluster slices (Sec. 4.2: representative slices keeping realistic contention)
# ----------------------------------------------------------------------------------


def make_cluster(name: str) -> ClusterSpec:
    """Representative cluster slice per trace (Sec. 4.2 of the paper)."""
    nodes: list[NodeSpec] = []
    nid = 0

    def add(n: int, gpu_type: str, gpus: int, cpus: int, mem: float, speed: float) -> None:
        nonlocal nid
        for _ in range(n):
            nodes.append(NodeSpec(nid, gpu_type, gpus, cpus, mem, speed))
            nid += 1

    if name == "philly":
        # P100 2-GPU and 8-GPU SKUs (Table 4)
        add(8, "P100", 2, 16, 128.0, 1.0)
        add(10, "P100", 8, 64, 512.0, 1.0)
    elif name == "helios":
        # VC slice: 10 nodes x 8 GPUs, mixed Pascal/Volta (Table 4, Sec 4.2 —
        # slice sized to keep realistic contention for the trace arrival rate)
        add(5, "P100", 8, 64, 512.0, 1.0)
        add(5, "V100", 8, 64, 512.0, 1.5)
    elif name == "alibaba":
        add(8, "T4", 2, 32, 256.0, 0.6)
        add(6, "P100", 2, 32, 256.0, 1.0)
        add(8, "V100", 8, 96, 768.0, 1.5)
    elif name == "slurm-testbed":
        # Sec. 5.6 heterogeneous testbed: 2xP100(4), 2xK80(2), 1xM40(1)
        add(2, "P100", 4, 32, 256.0, 1.0)
        add(2, "K80", 2, 16, 128.0, 0.4)
        add(1, "M40", 1, 8, 64.0, 0.5)
    else:
        raise ValueError(f"unknown cluster {name!r}")
    return ClusterSpec(nodes=nodes, name=name)


# ----------------------------------------------------------------------------------
# Synthetic generator
# ----------------------------------------------------------------------------------


def generate_trace(profile: TraceProfile | str, num_jobs: int, seed: int = 0) -> list[Job]:
    """Generate `num_jobs` jobs matching a trace profile. Deterministic in seed."""
    if isinstance(profile, str):
        profile = PROFILES[profile]
    rng = np.random.default_rng(seed)

    demands, dprobs = zip(*profile.gpu_demand)
    types, tprobs = zip(*profile.gpu_types)
    dprobs = np.asarray(dprobs) / sum(dprobs)
    tprobs = np.asarray(tprobs) / sum(tprobs)

    # lognormal runtimes matching the trace mean
    sigma = profile.runtime_sigma
    mu = math.log(profile.runtime_mean) - 0.5 * sigma * sigma

    # zipf-ish user popularity
    user_w = 1.0 / np.arange(1, profile.num_users + 1) ** 1.1
    user_w /= user_w.sum()

    jobs: list[Job] = []
    t = 0.0
    bursty = False
    for i in range(num_jobs):
        rate = profile.arrival_rate * (profile.burst_factor if bursty else 1.0)
        t += float(rng.exponential(1.0 / rate))
        if bursty:
            if rng.random() < profile.calm_prob:
                bursty = False
        elif rng.random() < profile.burst_prob:
            bursty = True

        runtime = float(np.clip(rng.lognormal(mu, sigma), 30.0, profile.max_runtime))
        est = float(np.clip(runtime * rng.lognormal(0.0, profile.est_noise_sigma),
                            30.0, profile.max_runtime * 2))
        jobs.append(Job(
            job_id=i,
            user=int(rng.choice(profile.num_users, p=user_w)),
            submit_time=t,
            runtime=runtime,
            est_runtime=est,
            num_gpus=int(rng.choice(demands, p=dprobs)),
            gpu_type=str(rng.choice(types, p=tprobs)),
            vc=int(rng.integers(0, 5)),
            arch=str(rng.choice(profile.archs)) if profile.archs else "",
        ))
    return jobs


#: Stand-in runtime for unknown-duration jobs with no estimate either.
DEFAULT_UNKNOWN_RUNTIME_S = 3600.0


def load_trace_csv(path: str) -> list[Job]:
    """Load a real trace in the normalized CSV schema.

    A missing or empty ``runtime`` cell marks the job unknown-duration
    (``duration_known=False``): its ``runtime`` falls back to the declared
    estimate (or :data:`DEFAULT_UNKNOWN_RUNTIME_S` when that is absent too)
    and the runtime predictor, not the declared value, is expected to serve
    its reservations.  Real traces routinely drop durations for killed or
    still-running jobs — rejecting the whole file over them loses the rest.
    """
    jobs: list[Job] = []
    with open(path, newline="") as f:
        for i, row in enumerate(csv.DictReader(f)):
            raw_rt = (row.get("runtime") or "").strip()
            raw_est = (row.get("est_runtime") or "").strip()
            known = bool(raw_rt)
            if known:
                rt = float(raw_rt)
                est = float(raw_est) if raw_est else rt
            else:
                est = float(raw_est) if raw_est \
                    else DEFAULT_UNKNOWN_RUNTIME_S
                rt = est
            jobs.append(Job(
                job_id=int(row.get("job_id", i)),
                user=int(row.get("user", 0)),
                submit_time=float(row["submit_time"]),
                runtime=rt,
                est_runtime=est,
                num_gpus=int(row["num_gpus"]),
                gpu_type=row.get("gpu_type", "any") or "any",
                vc=int(row.get("vc", 0) or 0),
                duration_known=known,
            ))
    jobs.sort(key=lambda j: j.submit_time)
    return jobs


def batch_iter(jobs: list[Job], batch_size: int = 256):
    """Yield consecutive job batches (the paper trains on batches of 256)."""
    for i in range(0, len(jobs) - batch_size + 1, batch_size):
        yield jobs[i:i + batch_size]


def train_eval_split(jobs: list[Job], train_frac: float = 0.9) -> tuple[list[Job], list[Job]]:
    """90/10 split per Sec. 3.1.1."""
    k = int(len(jobs) * train_frac)
    return jobs[:k], jobs[k:]

"""Cost model linking the scheduler to the DL platform substrate.

Job runtimes for platform-generated traces are derived from the per-arch
roofline terms (the port's own dry-run artifacts when present, the
analytic model at H100 rates otherwise): a training job of `steps` steps
on `chips` chips of a given GPU SKU takes  steps x max(compute, memory,
0.1 x collective) x (ref_chips / chips) / sku_speed  seconds.  This
closes the loop: RLTune schedules the same architectures whose
distributed execution the substrate traces.

The reference chip is one H100 (``launch.mesh``'s rates), and
``SKU_SPEED`` is relative to it.  The reference's table is relative to a
TPU v5e and its entries are ratios of bf16 peaks (V100 0.63 ~ 125/197), so
each entry here is the reference's times 197e12 / 989e12 (the v5e's bf16
peak over the H100's).  A compute-bound job's runtime on, say, V100 is
then what the reference gives; a memory-bound one's moves by the H100's
and the v5e's different HBM-to-compute ratios.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch.core.types import Job

_ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "benchmarks_torch", "artifacts", "dryrun",
                          "singlepod")

_V5E_OVER_H100 = 197e12 / 989e12
# relative throughput of cluster SKUs vs the roofline reference chip (H100)
SKU_SPEED = {"H100": 1.0,
             **{sku: ref * _V5E_OVER_H100 for sku, ref in
                {"v5e": 1.0, "V100": 0.63, "P100": 0.24, "T4": 0.33,
                 "K80": 0.11, "M40": 0.15, "any": 0.5}.items()}}


def _load_terms(arch: str, shape: str) -> dict | None:
    path = os.path.join(_ARTIFACTS, f"{arch}__{shape}.json")
    if os.path.exists(path):
        with open(path) as f:
            d = json.load(f)
        return {"compute_s": d["compute_s"], "memory_s": d["memory_s"],
                "collective_s": d["collective_s"], "chips": d["chips"]}
    return None


def step_time(arch: str, shape: str = "train_4k", chips: int = 256,
              sku: str = "H100") -> float:
    """Roofline-bound step time (s) for (arch, shape) on `chips` chips."""
    terms = _load_terms(arch, shape)
    if terms is None:
        from repro_torch.configs import get_config
        from repro_torch.launch.roofline import analytic_cost, roofline_terms
        from repro_torch.models.lm import LM
        cfg = get_config(arch)
        ana = analytic_cost(cfg, shape, chips=256,
                            model=LM(cfg, device="meta"))
        terms = {**roofline_terms(ana["flops_per_chip"],
                                  ana["hbm_bytes_per_chip"], 0.0),
                 "chips": 256}
    # production pipelines reduce-scatter + overlap collectives, and the
    # dry run's collective term is an upper bound, so it is weighted down
    # rather than let it dominate job runtimes (as in the reference)
    bound = max(terms["compute_s"], terms["memory_s"],
                0.1 * terms["collective_s"])
    return bound * terms["chips"] / max(chips, 1) / SKU_SPEED.get(
        sku, SKU_SPEED["any"])


def platform_job_runtime(arch: str, num_gpus: int, sku: str,
                         steps: int, shape: str = "train_4k") -> float:
    """Wall seconds for a training job of `steps` steps on num_gpus of sku."""
    return steps * step_time(arch, shape, chips=num_gpus, sku=sku)


def generate_platform_trace(num_jobs: int, seed: int = 0,
                            arrival_rate: float = 0.03) -> list[Job]:
    """A trace whose jobs are the assigned architectures with roofline-derived
    runtimes (alternative to the statistical Philly/Helios/Alibaba profiles).
    The random draws are the reference's, one for one."""
    from repro_torch.configs import ALL_ARCHS
    rng = np.random.default_rng(seed)
    jobs: list[Job] = []
    t = 0.0
    for i in range(num_jobs):
        t += float(rng.exponential(1.0 / arrival_rate))
        arch = str(rng.choice(ALL_ARCHS))
        num_gpus = int(rng.choice([1, 2, 4, 8, 16], p=[.35, .25, .2, .15, .05]))
        steps = int(rng.lognormal(4.0, 1.0))
        rt = float(np.clip(platform_job_runtime(arch, num_gpus, "V100", steps),
                           60.0, 7 * 86400.0))
        est = rt * float(rng.lognormal(0.0, 0.5))
        jobs.append(Job(job_id=i, user=int(rng.integers(0, 64)),
                        submit_time=t, runtime=rt, est_runtime=est,
                        num_gpus=num_gpus, gpu_type="any", arch=arch))
    return jobs

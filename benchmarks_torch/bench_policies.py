"""Paper Table 9 + Figs 11/12/14/15/16 on the port: RLTune vs the base
policies and vs the RLScheduler (``naive``: raw features, ``pack``) and
SchedInspector (``inspector``: an RL execute/skip gate over the base
ranking) mechanisms, across the three traces.  The analog of
``benchmarks/bench_policies.py``."""
from __future__ import annotations

import time

import numpy as np

from benchmarks_torch.common import (BATCH_SIZE, EVAL_BATCHES, eval_pair,
                                     get_trainer, row)
from repro_torch.core import PolicyPrioritizer, Simulator, make_policy

TRACES = ("philly", "helios", "alibaba")


def run(out: list[str]) -> None:
    print("# Table 9: policy comparison (per-trace: BSLD / WT / JCT / Util)")
    header = f"{'policy':16s} " + "".join(
        f"| {t:^34s} " for t in TRACES) + "| time(s)"
    print(header)

    # base policies (FIFO row of Table 9) — direct simulation
    for pol in ("fcfs", "sjf"):
        cells = []
        t0 = time.time()
        for trace in TRACES:
            tr = get_trainer(trace, pol, train=False)
            base_jobs = tr._batches(tr.eval_jobs, EVAL_BATCHES, BATCH_SIZE,
                                    np.random.default_rng(1234))
            sim = Simulator(tr.cluster, allocator="pack")
            ms = {"wait": [], "jct": [], "bsld": [], "util": []}
            for b in base_jobs:
                res = sim.run_batch([j.clone_pending() for j in b],
                                    PolicyPrioritizer(make_policy(pol, True)))
                ms["wait"].append(res.avg_wait)
                ms["jct"].append(res.avg_jct)
                ms["bsld"].append(res.avg_bsld)
                ms["util"].append(res.utilization)
            cells.append(f"{np.mean(ms['bsld']):7.1f} {np.mean(ms['wait']):8.0f} "
                         f"{np.mean(ms['jct']):8.0f} {np.mean(ms['util']):4.2f}")
        print(f"{pol:16s} " + "".join(f"| {c} " for c in cells)
              + f"| {time.time() - t0:.0f}")

    # RL variants: RLTune (pro), RLScheduler mechanism (naive), SchedInspector
    for variant, label in (("pro", "RLTune"), ("naive", "RLScheduler*"),
                           ("inspector", "SchedInspector*")):
        cells = []
        t0 = time.time()
        for trace in TRACES:
            tr = get_trainer(trace, "fcfs", "wait", variant)
            ev = eval_pair(tr)
            cells.append(f"{ev['bsld'][1]:7.1f} {ev['wait'][1]:8.0f} "
                         f"{ev['jct'][1]:8.0f} {ev['util'][1]:4.2f}")
            if variant == "pro":
                out.append(row(f"table9/{trace}/wait_improvement_pct", 0.0,
                               f"{ev['wait'][2]:+.1f}%"))
        print(f"{label:16s} " + "".join(f"| {c} " for c in cells)
              + f"| {time.time() - t0:.0f}")

    # Fig 12-style per-base-policy improvements (wait) on each trace
    print("\n# Fig 11/12: RL-enabled wait-time improvement per base policy")
    for trace in TRACES:
        for pol in ("fcfs", "sjf"):
            tr = get_trainer(trace, pol, "wait", "pro")
            ev = eval_pair(tr)
            b, r, imp = ev["wait"]
            print(f"  {trace:8s} {pol:6s}: {b:9.1f} -> {r:9.1f}  ({imp:+.1f}%)")
            out.append(row(f"fig12/{trace}/{pol}", 0.0, f"{imp:+.1f}%"))

    # Fig 16: Slurm multifactor baseline (BSLD)
    print("\n# Fig 16: vs Slurm multifactor (BSLD)")
    for trace in ("philly", "helios"):
        tr = get_trainer(trace, "slurm-mf", "bsld", "pro")
        ev = eval_pair(tr)
        b, r, imp = ev["bsld"]
        print(f"  {trace:8s} slurm-mf: BSLD {b:8.2f} -> {r:8.2f} ({imp:+.1f}%)")
        out.append(row(f"fig16/{trace}/slurm_bsld", 0.0, f"{imp:+.1f}%"))

"""Paper Fig 6 on the port: batch-wise workload variability, jobs exceeding
the global median wait vs total cumulative wait per consecutive batch
window (FCFS, ``pack``).  Host only: the analog of
``benchmarks/bench_variability.py``, with the same rows."""
from __future__ import annotations

import numpy as np

from benchmarks_torch.common import row
from repro_torch.core import (PolicyPrioritizer, Simulator, generate_trace,
                              make_cluster, make_policy)


def run(out: list[str]) -> None:
    print("# Fig 6: batch-wise congestion trajectories (FCFS, 20x128 jobs)")
    for trace in ("philly", "helios"):
        jobs = generate_trace(trace, 20 * 128, seed=5)
        sim = Simulator(make_cluster(trace), allocator="pack")
        waits_per_batch = []
        for i in range(20):
            batch = [j.clone_pending() for j in jobs[i * 128:(i + 1) * 128]]
            res = sim.run_batch(batch, PolicyPrioritizer(make_policy("fcfs")))
            waits_per_batch.append([j.wait_time for j in res.jobs])
        all_waits = np.concatenate(waits_per_batch)
        median = float(np.median(all_waits))
        over = [int(np.sum(np.asarray(w) > median)) for w in waits_per_batch]
        tot = [float(np.sum(w)) / 3600.0 for w in waits_per_batch]
        cv_over = float(np.std(over) / (np.mean(over) + 1e-9))
        print(f"  {trace:8s}: jobs>median per batch min={min(over)} "
              f"max={max(over)} (cv={cv_over:.2f}); total wait per batch "
              f"min={min(tot):.1f}h max={max(tot):.1f}h")
        out.append(row(f"fig6/{trace}/burstiness_cv", 0.0, f"{cv_over:.2f}"))
        # the paper's point: heavy variability across consecutive batches
        assert max(tot) > 2 * (min(tot) + 1e-9) or max(over) > 2 * min(over) + 1

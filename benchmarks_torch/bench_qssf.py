"""Paper Table 8 + Fig 17 on the port: RLTune vs QSSF (history-informed
SOTA) on Philly, all four metrics, plus a long-horizon consecutive-jobs JCT
comparison (QSSF with ``pack`` against the greedy agent with ``milp``;
queue rows past the actor's 256-row window keep FIFO order, as in the
reference).  The analog of ``benchmarks/bench_qssf.py``."""
from __future__ import annotations

from benchmarks_torch.common import SCALE, eval_pair, get_trainer, row
from repro_torch.core import (PolicyPrioritizer, RLPrioritizer, Simulator,
                              generate_trace, improvement, make_policy)


def fig17_runs(tr, n: int):
    """(QSSF result, RLTune result) over ``n`` consecutive Philly jobs
    (seed 77) on ``tr``'s cluster with ``tr``'s agent acting greedily."""
    jobs = generate_trace("philly", n, seed=77)
    qssf_res = Simulator(tr.cluster, allocator="pack").run_batch(
        [j.clone_pending() for j in jobs],
        PolicyPrioritizer(make_policy("qssf", True)))
    rl_res = Simulator(tr.cluster, allocator="milp").run_batch(
        [j.clone_pending() for j in jobs],
        RLPrioritizer(tr.agent, explore=False, use_estimates=True))
    return qssf_res, rl_res


def run(out: list[str]) -> None:
    print("# Table 8: QSSF vs RLTune on Philly (backfilling on)")
    tr = get_trainer("philly", "qssf", "wait")
    ev = eval_pair(tr)
    print(f"{'metric':8s} {'QSSF':>10s} {'RLTune':>10s} {'improvement':>12s}")
    for m in ("wait", "bsld", "jct", "util"):
        b, r, imp = ev[m]
        print(f"{m:8s} {b:10.2f} {r:10.2f} {imp:+11.1f}%")
        out.append(row(f"table8/{m}", 0.0, f"{imp:+.1f}%"))

    # Fig 17: long-horizon consecutive jobs (scaled from the paper's 10k)
    n = 2048 if SCALE == "quick" else 10_000
    print(f"\n# Fig 17: {n} consecutive jobs, JCT")
    qssf_res, rl_res = fig17_runs(tr, n)
    imp = improvement(qssf_res.avg_jct, rl_res.avg_jct)
    print(f"  QSSF JCT={qssf_res.avg_jct:.0f}s  RLTune JCT={rl_res.avg_jct:.0f}s"
          f"  ({imp:+.1f}%)")
    out.append(row("fig17/jct_10k", 0.0, f"{imp:+.1f}%"))

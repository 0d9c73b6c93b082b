"""Paper Table 6 on the port: utilization improvement across base policies
(FCFS, SJF) and traces, util-trained agents.  The analog of
``benchmarks/bench_util.py``."""
from __future__ import annotations

from benchmarks_torch.common import eval_pair, get_trainer, row

POLICIES = ("fcfs", "sjf")
TRACES = ("philly", "helios", "alibaba")


def run(out: list[str]) -> None:
    print("# Table 6: utilization improvement (RL vs base), util-trained")
    print(f"{'trace':10s} " + "".join(f"{p:>9s}" for p in POLICIES))
    for trace in TRACES:
        cells = []
        for pol in POLICIES:
            tr = get_trainer(trace, pol, metric="util")
            ev = eval_pair(tr)
            imp = ev["util"][2]
            cells.append(f"{imp:+8.2f}%")
            out.append(row(f"table6/{trace}/{pol}", 0.0, f"{imp:+.2f}%"))
        print(f"{trace:10s} " + "".join(cells))

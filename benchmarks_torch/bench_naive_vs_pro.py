"""Paper Fig 10 on the port: naive-RLTune (raw features, ``pack``) vs
pro-RLTune (engineered features + sampling + MILP allocation), BSLD on
Philly with the ``slurm-mf`` base policy.  The analog of
``benchmarks/bench_naive_vs_pro.py``; the agents act through the
policy-MLP kernel on the card."""
from __future__ import annotations

from benchmarks_torch.common import eval_pair, get_trainer, row
from repro_torch.core import improvement


def run(out: list[str]) -> None:
    print("# Fig 10: naive-RLTune vs pro-RLTune (philly, BSLD)")
    res = {}
    for variant in ("naive", "pro"):
        tr = get_trainer("philly", "slurm-mf", "bsld", variant)
        ev = eval_pair(tr)
        res[variant] = ev["bsld"][1]
        print(f"  {variant:6s}: BSLD {ev['bsld'][0]:.2f} -> {ev['bsld'][1]:.2f}")
    gain = improvement(res["naive"], res["pro"])
    print(f"  pro over naive: {gain:+.1f}% BSLD")
    out.append(row("fig10/pro_over_naive_bsld", 0.0, f"{gain:+.1f}%"))

"""Paper Table 7 on the port: cross-policy transfer on Helios.  Train the
agent against one base policy, evaluate its ranking under every other
(weights carried across with ``load_state_dict``).  The analog of
``benchmarks/bench_transfer.py``."""
from __future__ import annotations

from benchmarks_torch.common import (BATCH_SIZE, EVAL_BATCHES, bench_device,
                                     get_trainer, row)
from repro_torch.core import improvement
from repro_torch.core.trainer import RLTuneTrainer, TrainerConfig

POLICIES = ("fcfs", "sjf", "wfp3")


def run(out: list[str]) -> None:
    print("# Table 7: wait-time improvement, cross-policy transfer (helios)")
    agents = {p: get_trainer("helios", p, "wait").agent.state_dict()
              for p in POLICIES}
    hdr = "train\\test"
    print(f"{hdr:12s} " + "".join(f"{p:>9s}" for p in POLICIES))
    for src in POLICIES:
        cells = []
        for dst in POLICIES:
            cfg = TrainerConfig(trace="helios", base_policy=dst,
                                metric="wait", batch_size=BATCH_SIZE,
                                batches_per_epoch=1, epochs=1)
            tr = RLTuneTrainer(cfg, device=bench_device())
            tr.agent.load_state_dict(agents[src])
            ev = tr.evaluate(num_batches=EVAL_BATCHES, batch_size=BATCH_SIZE)
            imp = improvement(ev["base"]["wait"], ev["rl"]["wait"])
            cells.append(f"{imp:+8.1f}%")
            out.append(row(f"table7/{src}->{dst}", 0.0, f"{imp:+.1f}%"))
        print(f"{src:12s} " + "".join(cells))

"""Quickstart on the port: train RLTune on a Helios-like trace and beat the
base policy.

    PYTHONPATH=src python examples_torch/quickstart.py [--batches 25] [--trace helios] [--device cpu]

The analog of ``examples/quickstart.py``: the paper's core loop end-to-end,
synthetic production trace -> feature building -> PPO prioritization +
MILP allocation -> evaluation against the base policy on held-out jobs
(noisy runtime estimates).  The agent lives on ``--device`` (default the
card), where every decision, sampled in training and greedy in the
evaluation, runs the ``policy_mlp`` kernel.  ``main`` returns the
evaluation, ``{"base": {metric: value}, "rl": {...}}``.
"""
import argparse

from repro_torch.core import improvement
from repro_torch.core.trainer import RLTuneTrainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="helios",
                    choices=["philly", "helios", "alibaba"])
    ap.add_argument("--base-policy", default="fcfs")
    ap.add_argument("--metric", default="wait",
                    choices=["wait", "jct", "bsld", "util"])
    ap.add_argument("--batches", type=int, default=25)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the agent lives (default cuda)")
    args = ap.parse_args(argv)

    cfg = TrainerConfig(trace=args.trace, base_policy=args.base_policy,
                        metric=args.metric, batch_size=args.batch_size,
                        batches_per_epoch=args.batches, epochs=1)
    trainer = RLTuneTrainer(cfg, device=args.device)
    print(f"[quickstart] training RLTune vs {args.base_policy} on "
          f"{args.trace} ({args.batches} batches of {args.batch_size} jobs) "
          f"on {args.device}")
    hist = trainer.train(log_every=5)
    print(f"[quickstart] mean training reward: {hist[0].mean_reward:+.3f} "
          f"(positive = RL schedules better than the base policy)")

    ev = trainer.evaluate(num_batches=5)
    print("\n[quickstart] held-out evaluation (noisy user estimates):")
    for m in ("wait", "jct", "bsld", "util"):
        b, r = ev["base"][m], ev["rl"][m]
        imp = improvement(b, r, lower_is_better=(m != "util"))
        print(f"  {m:5s}: base={b:10.2f}  rltune={r:10.2f}  ({imp:+.1f}%)")
    return ev


if __name__ == "__main__":
    main()

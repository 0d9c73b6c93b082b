"""Fault-tolerant cluster scheduling on the port: RLTune scheduling
DL-platform jobs (the assigned architectures, runtimes from the roofline
cost model) on a heterogeneous cluster with node failures,
checkpoint/restart, and straggler migration.

    PYTHONPATH=src python examples_torch/cluster_failover.py [--device cpu]

The analog of ``examples/cluster_failover.py``: the agent trains and acts
on ``--device`` (default the card, where each decision runs the
``policy_mlp`` kernel); the FCFS arm runs on the host.  ``main`` returns
``{"fcfs": BatchResult, "rltune": BatchResult}``.
"""
import argparse

from repro_torch.core import (FaultModel, PolicyPrioritizer, Simulator,
                              improvement, make_cluster, make_policy)
from repro_torch.core.costmodel import generate_platform_trace
from repro_torch.core.env import RLPrioritizer
from repro_torch.core.trainer import RLTuneTrainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the agent lives (default cuda)")
    args = ap.parse_args(argv)

    jobs = generate_platform_trace(160, seed=0, arrival_rate=0.05)
    archs = sorted({j.arch for j in jobs})
    print(f"[failover] 160 platform jobs over {len(archs)} architectures "
          f"(runtimes from roofline cost model)")

    cluster = make_cluster("helios")
    faults = FaultModel(mtbf_per_node=6 * 3600.0, repair_time=1800.0,
                        ckpt_interval=900.0, straggler_prob=0.15, seed=3)

    # quick RLTune training on the same workload distribution (no faults)
    cfg = TrainerConfig(trace="helios", base_policy="fcfs", metric="jct",
                        batch_size=96, batches_per_epoch=12, epochs=1)
    trainer = RLTuneTrainer(cfg, cluster=cluster,
                            jobs=generate_platform_trace(1600, seed=1),
                            device=args.device)
    trainer.train()

    results = {}
    for name, prioritizer, alloc in (
        ("fcfs", PolicyPrioritizer(make_policy("fcfs", True)), "pack"),
        ("rltune", RLPrioritizer(trainer.agent, explore=False,
                                 use_estimates=True), "milp"),
    ):
        sim = Simulator(cluster, allocator=alloc, fault_model=faults,
                        straggler_migration=True)
        res = sim.run_batch([j.clone_pending() for j in jobs], prioritizer)
        results[name] = res
        print(f"  {name:7s}: jct={res.avg_jct:9.0f}s wait={res.avg_wait:8.0f}s "
              f"util={res.utilization:.3f} restarts={res.restarts} "
              f"(failures survived, work preserved at checkpoints)")

    imp = improvement(results["fcfs"].avg_jct, results["rltune"].avg_jct)
    print(f"[failover] RLTune vs FCFS under faults: JCT {imp:+.1f}%")
    return results


if __name__ == "__main__":
    main()

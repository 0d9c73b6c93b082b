"""Paper Sec. 5.7 operation costs on the port: per queue size, the state
build, the actor's hand-written kernel against its plain torch version, and
the MILP placement solve.

    PYTHONPATH=src python -m benchmarks_torch.bench_latency [--device cuda]

The analog of ``benchmarks/bench_latency.py``.  For each queue of 128, 256,
512 and 1,024 Helios jobs:

- ``state_ms``: ``build_state`` (the 256-row actor and critic vectors);
- ``kernel_us`` / ``plain_us``: the actor MLP over the whole queue, every
  row live (Q = the queue size), through ``ops.policy_mlp`` (the CUDA
  kernel on the card) and through ``ref.policy_mlp_ref`` (the same
  function in torch ops), each call synchronised and its logits copied to
  the host, as a ranking decision uses them;
- ``decision_ms``: ``build_state`` plus the actor's forward on the state,
  ``actor_logits`` as the decision loop calls it;
- ``milp_ms``: ``choose_allocation`` for a 12-GPU job with the queue's
  first 8 jobs as look-ahead, on the Helios cluster with half of every
  other node taken (so spread and pack are distinct ways and the solver
  runs; on an idle cluster one way is left and nothing is solved), solved
  each time (``solution_cache=False``); scipy HiGHS on the host.

Times are means over ``--repeats`` calls after one warm-up call.  The last
line of the output is one JSON object with every row; on the card the line
before it is the card's name and power limit from ``nvidia-smi``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

QUEUE_SIZES = (128, 256, 512, 1024)
LOOKAHEAD = 8
MILP_GPUS = 12


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mean_s(fn, repeats: int, device) -> float:
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / repeats


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def fragmented_cluster():
    """Helios with half of every other node's GPUs held by a long job."""
    from repro_torch.core import ClusterState, Job, make_cluster
    spec = make_cluster("helios")
    cluster = ClusterState(spec)
    for node in spec.nodes[::2]:
        half = node.num_gpus // 2
        cluster.allocate(Job(job_id=-1 - node.node_id, user=0,
                             submit_time=0.0, runtime=86400.0,
                             est_runtime=86400.0, num_gpus=half,
                             gpu_type=node.gpu_type), {node.node_id: half})
    return cluster


def run(device: str = "cuda", repeats: int = 50) -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.core import (ClusterState, Job, choose_allocation,
                                  generate_trace, make_cluster)
    from repro_torch.core.agent import PPOAgent, actor_logits
    from repro_torch.core.features import (build_features, build_state,
                                           sample_features)
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import policy_mlp_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    agent = PPOAgent(device=device)
    dev = agent.device
    flat = [t for lyr in agent.params["actor"] for t in (lyr["w"], lyr["b"])]
    cluster = ClusterState(make_cluster("helios"))
    busy = fragmented_cluster()
    probe = Job(job_id=0, user=0, submit_time=0.0, runtime=3600.0,
                est_runtime=3600.0, num_gpus=MILP_GPUS)
    ways = busy.candidate_ways(probe)
    rows = []
    for qsize in QUEUE_SIZES:
        jobs = generate_trace("helios", qsize, seed=1)
        state_s = _mean_s(lambda: build_state(jobs, cluster, now=1e5),
                          max(repeats // 10, 1), torch.device("cpu"))
        ov, _, mask = build_state(jobs, cluster, now=1e5)
        ov_t, mask_t = torch.from_numpy(ov).to(dev), torch.from_numpy(mask).to(dev)
        with torch.no_grad():
            fwd_s = _mean_s(lambda: actor_logits(agent.net, ov_t, mask_t).cpu(),
                            repeats, dev)
            feats = build_features(jobs, cluster, 1e5)
            queue, _ = sample_features(feats, cluster)
            x = torch.from_numpy(np.ascontiguousarray(queue)).to(dev)
            live = torch.ones(qsize, device=dev)
            kernel_s = _mean_s(lambda: ops.policy_mlp(
                x, agent.params["actor"], live).cpu(), repeats, dev)
            plain_s = _mean_s(lambda: policy_mlp_ref(x, *flat, live).cpu(),
                              repeats, dev)
            err = (ops.policy_mlp(x, agent.params["actor"], live)
                   - policy_mlp_ref(x, *flat, live)).abs().max().item()
        look = jobs[:LOOKAHEAD]
        solved = choose_allocation(busy, probe, ways, look,
                                   solution_cache=False)
        milp_s = _mean_s(lambda: choose_allocation(
            busy, probe, ways, look, solution_cache=False),
            max(repeats // 10, 1), torch.device("cpu"))
        row = {"queue": qsize, "state_ms": state_s * 1e3,
               "kernel_us": kernel_s * 1e6, "plain_us": plain_s * 1e6,
               "max_abs_err": err,
               "decision_ms": (state_s + fwd_s) * 1e3,
               "milp_ms": milp_s * 1e3, "milp_ways": len(ways),
               "milp_used_solver": solved.used_solver}
        rows.append(row)
        print(f"queue={qsize:5d}: state={row['state_ms']:8.3f} ms "
              f"actor kernel={row['kernel_us']:9.2f} us "
              f"plain={row['plain_us']:9.2f} us (Q={qsize}, max abs err "
              f"{err:.2e}) decision={row['decision_ms']:8.3f} ms "
              f"milp={row['milp_ms']:8.3f} ms")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmarks_torch.bench_latency",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the actor (default cuda)")
    ap.add_argument("--repeats", type=int, default=50,
                    help="timed calls per measurement (default 50)")
    args = ap.parse_args(argv)
    import torch
    device = torch.device(args.device)
    header = {"device": str(device), "torch": torch.__version__,
              "repeats": args.repeats}
    smi = None
    if device.type == "cuda":
        header["card"] = torch.cuda.get_device_name(device)
        smi = nvidia_smi_line()
    print(f"# Sec 5.7 operation costs on {header.get('card', args.device)}")
    rows = run(args.device, args.repeats)
    if smi is not None:
        header["nvidia_smi"] = smi
        print(smi)
    print(json.dumps({"bench": "latency", **header, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

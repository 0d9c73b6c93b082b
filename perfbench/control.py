"""The control of ``correct``, and the program's own readings, for the
limits in ``perfbench.check``.

    python3 -m perfbench.control --workload NAME --seeds 1,2,3 \\
        --seconds S --mode tf32|program [--agents 0,1 --trace-seeds 7,8]

``--mode tf32`` puts the reference MLPs in the place of the program's two
kernels (``kernels.ops.policy_mlp`` and ``predict_mlp``) and of the
predictor's SGD step, computed in the nearest precision below the
configuration's float32: TF32 (on the card, cuBLAS with TF32 allowed; on
the CPU and in the host's SGD step, every operand rounded to TF32's
10-bit mantissa).  A sound limit fails it.  ``--mode program`` runs the
program as it is.  Each seed is one run of the cell (set-up, a window of
``--seconds``, the check) in this process; one JSON line per seed gives
the compared numbers and ``correct``.  With ``--agents`` and
``--trace-seeds``, each agent runs on each trace alone as the cell's only
trace: datasets beyond the cell's own, for the program's lower readings
(a run's ``--seed`` changes none of the work).  The benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def to_tf32(t):
    """Round float32 values to TF32 (10 explicit mantissa bits), to
    nearest with ties away from zero, as the tensor cores read them."""
    import torch
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def mlp_tf32(x, layers):
    """tanh MLP with every product in TF32."""
    import torch
    h = x.float()
    for k, (w, b) in enumerate(layers):
        if h.is_cuda:
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                h = h @ w + b
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
        else:
            h = to_tf32(h) @ to_tf32(w) + b
        if k < len(layers) - 1:
            h = torch.tanh(h)
    return h


def np_tf32(a):
    """``to_tf32`` for a numpy array (float32 out)."""
    import numpy as np
    bits = np.ascontiguousarray(a, np.float32).view(np.int32)
    bits = (bits + np.int32(0x1000)) & np.int32(~0x1FFF)
    return bits.view(np.float32)


def sgd_step_tf32(self, x, y):
    """The predictor's pinball-loss SGD step with every product's operands
    in TF32 (the same arithmetic as the program's float32 step
    otherwise)."""
    import numpy as np
    t = np_tf32
    p = self.params
    x = np.asarray(x, np.float32)
    h1 = np.tanh(t(x) @ t(p["w1"]) + p["b1"])
    h2 = np.tanh(t(h1) @ t(p["w2"]) + p["b2"])
    q = t(h2) @ t(p["w3"]) + p["b3"]
    taus = np.asarray(self.quantiles, np.float32)
    g = np.where(q >= y, 1.0 - taus, -taus).astype(np.float32)
    dz2 = (t(p["w3"]) @ t(g)) * (1.0 - h2 * h2)
    dz1 = (t(p["w2"]) @ t(dz2)) * (1.0 - h1 * h1)
    lr = np.float32(self.lr)
    p["w3"] -= lr * np.outer(t(h2), t(g))
    p["b3"] -= lr * g
    p["w2"] -= lr * np.outer(t(h1), t(dz2))
    p["b2"] -= lr * dz2
    p["w1"] -= lr * np.outer(t(x), t(dz1))
    p["b1"] -= lr * dz1
    self.updates += 1
    return 0.0


def install_tf32() -> None:
    """Put the TF32 reference in the place of the program's kernels and of
    its predictor's SGD step."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.predict.predictor import QuantileMLP

    QuantileMLP.sgd_step = sgd_step_tf32

    def policy_mlp(x, params, mask):
        out = mlp_tf32(x, [(p["w"], p["b"]) for p in params])[:, 0]
        return torch.where(mask > 0, out, torch.full_like(out, -1e9))

    def predict_mlp(x, params):
        return mlp_tf32(x, [(params["w1"], params["b1"]),
                            (params["w2"], params["b2"]),
                            (params["w3"], params["b3"])])

    ops.policy_mlp = policy_mlp
    ops.predict_mlp = predict_mlp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--mode", choices=("tf32", "program"), required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--agents", default="",
                    help="agent seeds: with --trace-seeds, run each agent "
                         "on each trace alone (datasets beyond the cell's)")
    ap.add_argument("--trace-seeds", default="")
    args = ap.parse_args(argv)
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch

    from perfbench import run
    if args.mode == "tf32":
        install_tf32()
    device = torch.device(args.device)
    datasets = [None]
    if args.agents and args.trace_seeds:
        datasets = [{"config": {"agent_seed": int(a)},
                     "traffic": {"trace_seeds": [int(t)]}}
                    for a in args.agents.split(",")
                    for t in args.trace_seeds.split(",")]
    for data in datasets:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            result, notes = run.measure(ROOT, args.workload, seed,
                                        args.seconds, False, device, data)
            print(json.dumps({
                "workload": args.workload, "mode": args.mode, "seed": seed,
                "dataset": data, "correct": result["correct"],
                "compared": result["compared"],
                "wall_s": round(time.perf_counter() - t0, 3),
                "notes": [n for n in notes if "check" in n or "trace 0" in n
                          or n.startswith("window")]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

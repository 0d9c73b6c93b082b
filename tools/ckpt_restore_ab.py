#!/usr/bin/env python3
"""Time the sharded restore of ``chip_smoke.py`` phase 24 (a) under the
checkpoint code of several checkouts, in turns, on one card.

    python3 tools/ckpt_restore_ab.py ROOT [ROOT ...] [--rounds N]

Each ROOT is a checkout of this repository (for example a parent commit
unpacked with ``git archive`` into a git-ignored directory, and ``.``).  In
one world-1 NCCL process on the 1x1 host mesh, the state that phase 24 (a)
checkpoints is built as ``train_loop(mesh=...)`` builds it: granite-moe-
1b-a400m at full width, params and AdamW moments as DTensors.  This
checkout's ``save_checkpoint`` writes it once; then each round restores it
with each ROOT's ``src/repro_torch/ckpt/checkpoint.py`` in the order given
and again in reverse (A B B A), every restore checked bit for bit against
the saved state.  The files stay in the page cache between restores, as
they do in phase 24, which restores right after it saves.  Prints the
card's name and power limit, one JSON line per restore and, last, one JSON
object with each root's seconds.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))
ARCH = "granite-moe-1b-a400m"
CKPT = HERE / "build" / "ckpt_restore_ab"


def load_module(root: Path, i: int):
    """``root``'s checkpoint module, under a name of its own (it imports
    ``repro_torch.ckpt._msgpack`` and ``repro_torch.sharding.specs`` from
    this checkout)."""
    spec = importlib.util.spec_from_file_location(
        f"ckpt_root{i}", root / "src" / "repro_torch" / "ckpt" / "checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM, ModelImpl
    from repro_torch.sharding.specs import DEFAULT_RULES
    from repro_torch.train.optimizer import opt_init, tree_leaves
    from repro_torch.train.step import distribute_tree, sharded_specs

    if not torch.cuda.is_available():
        print("ckpt_restore_ab: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    mods = [load_module(r.resolve(), i) for i, r in enumerate(args.roots)]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_host_mesh()
        model = LM(get_config(ARCH), ModelImpl(attn="xla", ssd="xla",
                                                moe="xla"),
                   device="cuda", rules=DEFAULT_RULES)
        pspecs, ospecs = sharded_specs(model, mesh)
        params = model.init(0, mesh=mesh)
        state = {"params": params,
                 "opt": distribute_tree(opt_init(params), ospecs, mesh)}
        place = {"params": pspecs, "opt": ospecs}
        nbytes = sum(t.to_local().numel() * t.element_size()
                     for _, t in tree_leaves(state))
        shutil.rmtree(CKPT, ignore_errors=True)
        t0 = time.perf_counter()
        save_checkpoint(str(CKPT), 1, state)
        print(json.dumps({"save_s": time.perf_counter() - t0,
                          "state_bytes": nbytes}), flush=True)
        order = list(range(len(mods)))
        times: dict[str, list[float]] = {str(r): [] for r in args.roots}
        for rnd in range(args.rounds):
            for i in order + order[::-1]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got, _ = mods[i].load_checkpoint(str(CKPT), state, mesh=mesh,
                                                 spec_tree=place)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                same = all(isinstance(a, DTensor)
                           and a.placements == b.placements
                           and torch.equal(a.to_local(), b.to_local())
                           for (_, a), (_, b) in zip(tree_leaves(got),
                                                     tree_leaves(state)))
                del got
                torch.cuda.empty_cache()
                if not same:
                    print(f"ckpt_restore_ab: {args.roots[i]} restored other "
                          "values", file=sys.stderr)
                    return 1
                times[str(args.roots[i])].append(sec)
                print(json.dumps({"round": rnd, "root": str(args.roots[i]),
                                  "restore_s": sec}), flush=True)
        print(json.dumps({"arch": ARCH, "state_bytes": nbytes, "restore_s": {
            r: {"all": t, "median": statistics.median(t)}
            for r, t in times.items()}}))
    finally:
        shutil.rmtree(CKPT, ignore_errors=True)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

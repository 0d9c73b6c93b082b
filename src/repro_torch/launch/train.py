"""The training entry point, on one device or on a mesh.

Deterministic restart-safe data, periodic async checkpoints, restore and
continue (elastic: onto whatever mesh is running), gradient-accumulation
microbatching and step-time logging, as the reference's `launch/train.py`;
the model trains on its plain paths (``ModelImpl(attn="xla", ssd="xla",
moe="xla")``: no kernel has a backward) with every layer rematerialized.
Given a mesh, params and optimizer state are DTensors placed by the
reference's rules and the step is ``shard_train_step``'s.

Smoke mode on the CPU (reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
      --smoke --steps 20 --batch 8 --seq 128 --device cpu
Without ``--device`` it runs on the GPU (``cuda``) and raises where there is
none.  On the production meshes, one process per card (NCCL):
  torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \\
      --arch yi-6b --production-mesh          # 16x16: 256 ranks
  ... --multi-pod                             # 2x16x16: 512 ranks
(``--device cpu`` runs the ranks over gloo.)  A world of the wrong size
raises.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.agent import _resolve_device
from repro_torch.data import SyntheticLMDataset
from repro_torch.models.lm import LM, ModelImpl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding.specs import DEFAULT_RULES
from repro_torch.train.optimizer import OptConfig, opt_init
from repro_torch.train.step import (distribute_tree, make_train_step,
                                    shard_train_step, sharded_specs)


def train_loop(arch: str, *, smoke: bool = False, steps: int = 50,
               batch: int = 8, seq: int = 128, microbatches: int = 1,
               ckpt_dir: str | None = None, ckpt_interval: int = 20,
               log_every: int = 10, lr: float = 3e-4, resume: bool = True,
               loss_chunk: int = 0,
               device: torch.device | str | None = None, mesh=None) -> dict:
    """Train ``arch`` from seeded weights (or from the newest checkpoint in
    ``ckpt_dir``) up to ``steps``, on ``device`` or, given ``mesh`` (a
    DeviceMesh; every rank calls this), sharded over it.  Returns {losses,
    gnorms, step_s, final_loss, params, opt_state, start_step}: per step
    run, the loss, the global gradient norm and the step's seconds (host
    clock, from the batch's upload to the loss read, which synchronises);
    on a mesh params and opt_state are DTensors."""
    dev = _resolve_device(device if mesh is None else mesh.device_type,
                          "train_loop")
    cfg = get_config(arch, smoke=smoke)
    rules = DEFAULT_RULES if mesh is not None else None
    model = LM(cfg, impl=ModelImpl(attn="xla", ssd="xla", moe="xla",
                                   loss_chunk=loss_chunk), device=dev,
               rules=rules)
    opt_cfg = OptConfig(lr=lr, warmup_steps=max(steps // 10, 5),
                        total_steps=steps)
    step_fn = make_train_step(model, opt_cfg, microbatches=microbatches)

    ds = SyntheticLMDataset(cfg.vocab_size, seq, batch, seed=0)
    mgr = CheckpointManager(ckpt_dir, interval=ckpt_interval) if ckpt_dir \
        else None
    place = None
    if mesh is None:
        params = model.init(0)
        opt_state = opt_init(params)
    else:
        # shard as drawn: no rank ever holds the full params or moments
        step_fn, _ = shard_train_step(model, step_fn, mesh, rules)
        pspecs, ospecs = sharded_specs(model, mesh, rules)
        place = {"params": pspecs, "opt": ospecs}
        params = model.init(0, mesh=mesh)
        opt_state = distribute_tree(opt_init(params), ospecs, mesh)
    start_step = 0
    if mgr is not None and resume:
        restored, at = mgr.restore({"params": params, "opt": opt_state},
                                   mesh=mesh, spec_tree=place)
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start_step = int(at)
            print(f"[train] restored checkpoint at step {start_step}")

    losses, gnorms, step_s = [], [], []
    t0 = time.perf_counter()
    try:
        for step in range(start_step, steps):
            hbatch = ds.batch_at(step)
            ts = time.perf_counter()
            dbatch = {k: torch.from_numpy(v).to(dev) for k, v in hbatch.items()}
            params, opt_state, metrics = step_fn(params, opt_state, dbatch)
            loss = float(metrics["loss"])
            step_s.append(time.perf_counter() - ts)
            losses.append(loss)
            gnorms.append(metrics["gnorm"])
            if mgr is not None:
                mgr.maybe_save(step + 1, {"params": params, "opt": opt_state})
            if log_every and (step + 1) % log_every == 0:
                dt = (time.perf_counter() - t0) / max(step + 1 - start_step, 1)
                print(f"[train] step {step + 1}/{steps} loss={loss:.4f} "
                      f"gnorm={float(metrics['gnorm']):.3f} "
                      f"{dt * 1e3:.0f} ms/step", flush=True)
    finally:
        if mgr is not None:
            mgr.close()
    return {"losses": losses, "gnorms": [float(g) for g in gnorms],
            "step_s": step_s, "final_loss": losses[-1] if losses else None,
            "params": params, "opt_state": opt_state,
            "start_step": start_step}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 mesh: 256 ranks (torchrun)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh: 512 ranks (torchrun)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sharded = args.production_mesh or args.multi_pod
    mesh = None
    if sharded:
        dev = _resolve_device(args.device, "train")
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        if sharded:
            mesh = make_production_mesh(multi_pod=args.multi_pod,
                                        device_type=dev.type)
        out = train_loop(args.arch, smoke=args.smoke, steps=args.steps,
                         batch=args.batch, seq=args.seq,
                         microbatches=args.microbatches,
                         ckpt_dir=args.ckpt_dir,
                         ckpt_interval=args.ckpt_interval, lr=args.lr,
                         device=args.device, mesh=mesh)
    finally:
        if sharded:
            dist.destroy_process_group()
    print(f"[train] done; final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()

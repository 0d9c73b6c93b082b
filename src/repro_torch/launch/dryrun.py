"""Multi-pod dry run: trace one step of an (arch x shape x mesh) cell on the
production mesh without hardware.

A ``fake`` process group of 256 (16x16) or 512 (2x16x16) ranks stands in
for the cluster, and ``FakeTensorMode`` for memory: parameters, optimizer
state, caches and the batch are DTensors over fake local shards, so
nothing is allocated, and one train step, prefill or decode runs on them
as the sharded program would on one rank (a Shard -> Shard redistribution
issued as the card's all-to-all, ``card_alltoall``, not as the ``cpu``
mesh's all-gather).  That proves the sharding is coherent (every op
propagates, every spec divides) and records, as JSON
under ``benchmarks_torch/artifacts/dryrun/{singlepod,multipod}/``, the
reference's record: analytic compute / memory seconds at H100 rates, the
collective bytes the step issued per chip (``CollectiveCounter``), the
traced FLOPs per chip, and memory per device from local shard shapes plus
the peak that torch's memory tracker reports for the step.

The model runs its plain paths (``ModelImpl(attn="xla", ssd="xla",
moe="xla")``), as the reference's dry run does by default; a fake tensor
cannot enter a CUDA kernel.  One process holds one default process group,
so each mesh (the CLI runs one per ``--multi-pod`` choice) gets its own
group, destroyed after.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import (ALL_ARCHS, SHAPES, get_config, input_specs,
                                 shape_applicable)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (CollectiveCounter, analytic_cost,
                                         model_flops, roofline_terms)
from repro_torch.models.lm import LM, ModelImpl
from repro_torch.sharding.specs import (DEFAULT_RULES, logical_spec,
                                        placements, sanitize_spec,
                                        sanitize_tree)
from repro_torch.train.optimizer import (OptConfig, abstract_opt_state,
                                         map_tree, opt_specs, tree_leaves)
from repro_torch.train.step import (distribute_tree, make_train_step,
                                    shard_train_step)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "benchmarks_torch", "artifacts", "dryrun")

# per-arch train-step microbatching (activation memory control at batch 256)
TRAIN_MICROBATCHES = {
    "qwen3-moe-235b-a22b": 16,
    "jamba-v0.1-52b": 8,
    "nemotron-4-15b": 8,
    "yi-6b": 4,
    "internvl2-2b": 2,
    "h2o-danube-1.8b": 2,
    "stablelm-1.6b": 2,
    "granite-moe-1b-a400m": 2,
    "mamba2-780m": 2,
    "whisper-tiny": 1,
}
LOSS_CHUNK = {"nemotron-4-15b": 512, "qwen3-moe-235b-a22b": 512}


def init_fake_world(world_size: int) -> None:
    """A ``fake`` default process group of ``world_size`` ranks (this
    process is rank 0): collectives return at once, moving no data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


@contextlib.contextmanager
def card_alltoall():
    """While open, DTensor's Shard(i) -> Shard(j) step issues the all-to-all
    that it issues on the card (``torch.ops._dtensor.shard_dim_alltoall``,
    which has a fake), where on a ``cpu`` mesh torch falls back to an
    all-gather of the whole dim and a chunk: the dry run's mesh is ``cpu``,
    and ``CollectiveCounter`` must count what the card would move.  Every
    module that bound torch's function by name gets the replacement, and
    torch's function is back when the window closes."""
    import sys
    from torch.distributed.tensor import _collective_utils

    real = _collective_utils.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    owners = [m for name, m in list(sys.modules.items())
              if name.startswith("torch.distributed.tensor")
              and getattr(m, "shard_dim_alltoall", None) is real]
    for m in owners:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m in owners:
            m.shard_dim_alltoall = real


def _place(abstract, spec_tree, mesh):
    """DTensors of the abstract (meta) tree's shapes and dtypes, placed by
    the specs; under ``FakeTensorMode`` nothing is allocated."""
    return distribute_tree(map_tree(
        lambda t: torch.empty(t.shape, dtype=t.dtype), abstract),
        spec_tree, mesh)


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size()
               for _, t in tree_leaves(tree))


BY_OP = 40


def _largest(d: dict[str, int]) -> dict[str, int]:
    return dict(sorted(d.items(), key=lambda kv: -kv[1])[:BY_OP])


def _batch_specs(cfg, shape, mesh, rules, microbatches: int = 1) -> dict:
    """Specs for the input batch dict, sanitized against one microbatch's
    shape (as ``train.step.microbatch_placements`` lays a batch out)."""
    specs = {}
    for key, (shp, _) in input_specs(cfg, shape).items():
        if key in ("tokens", "labels"):
            lg = ("batch", "seq")
        elif key == "patch_embeds":
            lg = ("batch", "seq", "embed_act")
        else:  # audio_frames
            lg = ("batch", "frames", "embed_act")
        specs[key] = sanitize_spec(
            logical_spec(lg[:len(shp)], rules, mesh),
            (shp[0] // microbatches,) + tuple(shp[1:]), mesh)
    return specs


def lower_cell(arch: str, shape_name: str, mesh, rules=None,
               impl: ModelImpl | None = None,
               microbatches: int | None = None) -> dict:
    """Trace one step of the cell on ``mesh`` (a DeviceMesh over a fake
    process group) under FakeTensorMode; returns the record.
    ``shape_name`` names one of ``SHAPES``, or is a ``ShapeConfig``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    rules = rules or DEFAULT_RULES
    cfg = get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    impl = impl or ModelImpl(attn="xla", ssd="xla", moe="xla",
                             loss_chunk=LOSS_CHUNK.get(arch, 0))
    model = LM(cfg, impl=impl, device=mesh.device_type, rules=rules)
    chips = mesh.size()
    B, S = shape.global_batch, shape.seq_len
    mb = (microbatches if microbatches is not None else
          TRAIN_MICROBATCHES.get(arch, 1)) if shape.kind == "train" else 1

    abstract_params = model.abstract_params()
    pspecs = sanitize_tree(model.param_specs(rules, mesh), abstract_params,
                           mesh)
    bspecs = _batch_specs(cfg, shape, mesh, rules, mb)
    counter = CollectiveCounter()
    mem = {"opt_bytes": 0, "grad_bytes": 0, "cache_bytes": 0}
    t0 = time.time()
    with FakeTensorMode():
        params = _place(abstract_params, pspecs, mesh)
        batch = {k: distribute_tensor(torch.zeros(shp, dtype=dt), mesh,
                                      placements(bspecs[k], mesh))
                 for k, (shp, dt) in input_specs(cfg, shape).items()}
        mem["param_bytes"] = _local_bytes(params)
        if shape.kind == "train":
            opt_state = _place(abstract_opt_state(abstract_params),
                               opt_specs(pspecs), mesh)
            mem["opt_bytes"] = _local_bytes(opt_state)
            mem["grad_bytes"] = sum(   # f32, placed as the params
                t.to_local().numel() * 4 for _, t in tree_leaves(params))
            step, _ = shard_train_step(
                model, make_train_step(model, OptConfig(), microbatches=mb),
                mesh, rules)

            def run():
                return step(params, opt_state, batch)
        else:
            cache = None
            if shape.kind == "decode":
                cspecs = sanitize_tree(model.cache_specs(B, S, rules, mesh),
                                       model.abstract_cache(B, S), mesh)
                cache = {"blocks": _place(model.abstract_cache(B, S),
                                          cspecs, mesh)["blocks"],
                         "len": S - 1}
                mem["cache_bytes"] = _local_bytes(cache["blocks"])

            def run():
                with torch.no_grad(), implicit_replication():
                    if cache is not None:
                        return model.decode_step(params, batch["tokens"],
                                                 cache)
                    return model.prefill(
                        params, batch["tokens"],
                        patch_embeds=batch.get("patch_embeds"),
                        audio_frames=batch.get("audio_frames"))

        with counter, card_alltoall():
            out = run()
        if shape.kind == "prefill":
            mem["cache_bytes"] = _local_bytes(out[1]["blocks"])
        del out
    trace_s = time.time() - t0

    coll = counter.record()
    counts = coll.pop("_counts")
    coll_total = sum(coll.values())
    ana = analytic_cost(cfg, shape, microbatches=mb, remat=impl.remat,
                        chips=chips, model=model)
    terms = roofline_terms(ana["flops_per_chip"], ana["hbm_bytes_per_chip"],
                           coll_total)
    mflops = model_flops(cfg, shape, model.active_param_count())
    peak = counter.peak_bytes
    resident = mem["param_bytes"] + mem["opt_bytes"] + mem["cache_bytes"]
    return {
        "arch": arch, "shape": shape.name, "mesh": list(mesh.shape),
        "chips": chips, "trace_s": round(trace_s, 2), "microbatches": mb,
        "flops_per_chip": ana["flops_per_chip"],
        "flops_global": ana["flops_global"],
        "hbm_bytes_per_chip": ana["hbm_bytes_per_chip"],
        "hlo_flops_per_chip": float(counter.flops),
        "collective_bytes": coll, "collective_counts": counts,
        "collective_total": coll_total,
        # the traced FLOPs and collective bytes by op and argument shapes,
        # largest first (the first BY_OP entries)
        "flops_by_op": _largest(counter.flops_by_op),
        "collective_by_op": _largest(counter.bytes_by_op),
        "model_flops": mflops,
        "useful_flops_frac": mflops / ana["flops_global"]
        if ana["flops_global"] else 0.0,
        "memory": {
            # resident state from local shard shapes, plus the step's own
            # peak (its activations, temporaries and gradients) as the
            # counter tracked it on the local shards
            "bytes_per_device": resident + peak,
            "param_bytes": mem["param_bytes"], "opt_bytes": mem["opt_bytes"],
            "grad_bytes": mem["grad_bytes"], "cache_bytes": mem["cache_bytes"],
            "peak_step_bytes": peak,
        },
        **terms,
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--by-op", type=int, default=0, metavar="N",
                    help="print each cell's N largest FLOP and collective "
                         "entries by op")
    args = ap.parse_args(argv)

    out_dir = args.out or os.path.abspath(ARTIFACT_DIR)
    archs = ALL_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for multi_pod in meshes:
        init_fake_world(512 if multi_pod else 256)
        try:
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            mesh_tag = "multipod" if multi_pod else "singlepod"
            path = os.path.join(out_dir, mesh_tag)
            os.makedirs(path, exist_ok=True)
            for arch in archs:
                cfg = get_config(arch)
                for shape_name in shapes:
                    if not shape_applicable(cfg, shape_name):
                        print(f"[skip] {arch} x {shape_name} (full attention)")
                        continue
                    tag = f"{mesh_tag}/{arch}__{shape_name}"
                    t0 = time.time()
                    try:
                        rec = lower_cell(arch, shape_name, mesh,
                                         microbatches=args.microbatches)
                    except Exception as e:  # noqa: BLE001 - report every cell
                        failures.append((tag, repr(e)))
                        print(f"[FAIL] {tag} after {time.time() - t0:.0f}s: "
                              f"{e}", flush=True)
                        traceback.print_exc()
                        continue
                    gib = rec["memory"]["bytes_per_device"] / 2**30
                    print(f"[ok]   {tag}: trace={rec['trace_s']}s "
                          f"mem/dev={gib:.2f}GiB "
                          f"compute={rec['compute_s'] * 1e3:.1f}ms "
                          f"mem={rec['memory_s'] * 1e3:.1f}ms "
                          f"coll={rec['collective_s'] * 1e3:.1f}ms "
                          f"dom={rec['dominant']}", flush=True)
                    for key in ("flops_by_op", "collective_by_op")[
                            :2 if args.by_op else 0]:
                        for op, n in list(rec[key].items())[:args.by_op]:
                            print(f"       {key[:-6]:<10} {n:>16} {op}")
                    with open(os.path.join(path, f"{arch}__{shape_name}.json"),
                              "w") as f:
                        json.dump(rec, f, indent=1)
        finally:
            dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err}")
        raise SystemExit(1)
    print("\nAll dry-run cells traced successfully.")


if __name__ == "__main__":
    main()

"""Perf hillclimb on the port's dry run: re-trace chosen cells under
candidate rules, microbatches and model paths, and record hypothesis ->
change -> before/after.

The analog of ``benchmarks/hillclimb.py``, with its cells, tags,
hypotheses and settings (the hypotheses are the reference's, written
against its TPU lowering; the records here are the port's, at H100
rates):
  - mamba2-780m  x train_4k : the reference's worst roofline fraction
  - qwen3-moe    x train_4k : its most collective-bound cell
  - yi-6b        x train_4k : its representative dense-FSDP case

Each experiment traces one step on a fake 256-rank process group, the
16x16 production mesh (``launch.dryrun.lower_cell``), prints compute,
memory and collective seconds a chip, the dominant term, the roofline
fraction, the step's peak bytes a chip (``memory.peak_step_bytes``, where
the reference prints its compiled temporaries) and the trace's seconds,
and writes the cell's records to
``benchmarks_torch/artifacts/hillclimb/{cell}.json``.  An experiment that
raises is recorded with its ``error`` and the cell goes on.  The model
runs its plain paths: every ``ModelImpl`` of the list has ``ssd="xla"``,
``moe="xla"`` and the reference's ``attn`` (a fake tensor cannot enter a
CUDA kernel).

Run:  PYTHONPATH=src python -m benchmarks_torch.hillclimb [cell ...]
"""
from __future__ import annotations

import json
import os
import sys
import time

from repro_torch.models.lm import ModelImpl
from repro_torch.sharding.specs import (DEFAULT_RULES, DP_ONLY_RULES,
                                        TP_ONLY_RULES)

ART = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts",
                   "hillclimb")


def _impl(attn: str = "xla", **kw) -> ModelImpl:
    """The reference's ``ModelImpl(...)`` on the port's plain paths."""
    return ModelImpl(attn=attn, ssd="xla", moe="xla", **kw)


# experiment list: (cell, tag, hypothesis, kwargs for lower_cell)
EXPERIMENTS = {
    "mamba2": [
        ("mamba2-780m", "train_4k", "baseline",
         "as-recorded baseline (FSDP rules, mb=2)", {}),
        ("mamba2-780m", "train_4k", "tp_only",
         "0.78B params fit TP-only; dropping FSDP removes per-layer weight "
         "all-gathers + full-size grad all-reduces over data (predict "
         "collective ~10-100x down)",
         dict(rules=TP_ONLY_RULES)),
        ("mamba2-780m", "train_4k", "tp_only_mb1",
         "collectives scale with microbatch count; mb 2->1 halves grad "
         "reduction traffic (activation temp x2, fits)",
         dict(rules=TP_ONLY_RULES, microbatches=1)),
        ("mamba2-780m", "train_4k", "dp_only_mb1",
         "0.78B params+opt = 7.8 GiB replicated per chip: pure DP over all "
         "256 chips removes every TP activation all-reduce; only one "
         "~6 GiB grad all-reduce remains (predict coll ~0.2s, "
         "compute-bound at last)",
         dict(rules=DP_ONLY_RULES, microbatches=1)),
    ],
    "yi": [
        ("yi-6b", "train_4k", "baseline",
         "as-recorded baseline (FSDP rules, mb=4)", {}),
        ("yi-6b", "train_4k", "tp_only",
         "6B params+opt = 3.75 GiB/chip TP-only; removing FSDP eliminates "
         "920 GiB/chip of gathers -> grad all-reduce only (predict "
         "collective ~0.3-1s, compute-bound)",
         dict(rules=TP_ONLY_RULES)),
        ("yi-6b", "train_4k", "tp_only_mb2",
         "fewer microbatches: grad all-reduce bytes scale with mb (4->2)",
         dict(rules=TP_ONLY_RULES, microbatches=2)),
        ("yi-6b", "train_4k", "tp_only_mb2_chunkloss",
         "chunked cross-entropy shrinks the live fp32 logits slab",
         dict(rules=TP_ONLY_RULES, microbatches=2,
              impl=_impl(loss_chunk=512))),
        ("yi-6b", "train_4k", "tp_only_mb1",
         "continue the confirmed mb trend under TP-only (11.3s at mb=2 -> "
         "predict ~5.6s at mb=1; activation AR bytes halve again)",
         dict(rules=TP_ONLY_RULES, microbatches=1,
              impl=_impl(loss_chunk=512, attn="xla_chunked"))),
        ("yi-6b", "train_4k", "fsdp_mb1_chunked",
         "REVISED after tp_only refutation: FSDP's gathers were cheap "
         "(16 GiB); the 900 GiB is per-mb grad all-reduces. mb=1 pays the "
         "grad reduction ONCE (predict coll ~1-3s, compute-bound); chunked "
         "attention + chunked loss absorb the 4x activation growth",
         dict(microbatches=1,
              impl=_impl(loss_chunk=512, attn="xla_chunked"))),
    ],
    "qwen3": [
        ("qwen3-moe-235b-a22b", "train_4k", "baseline",
         "as-recorded baseline (FSDP required at 235B; mb=16)", {}),
        ("qwen3-moe-235b-a22b", "train_4k", "mb8_chunked",
         "FSDP gathers repeat per microbatch: mb 16->8 halves collective; "
         "chunked attention + chunked loss absorb the 2x activation growth",
         dict(microbatches=8,
              impl=_impl(loss_chunk=512, attn="xla_chunked"))),
        ("qwen3-moe-235b-a22b", "train_4k", "mb4_chunked",
         "push further: mb 16->4 quarters collective traffic",
         dict(microbatches=4,
              impl=_impl(loss_chunk=512, attn="xla_chunked"))),
        ("qwen3-moe-235b-a22b", "train_4k", "mb8_dots",
         "remat=dots saves matmul outputs so backward skips the re-gather "
         "forward pass (predict collective x2/3, temp up)",
         dict(microbatches=8,
              impl=_impl(loss_chunk=512, attn="xla_chunked",
                         remat_policy="dots"))),
        ("qwen3-moe-235b-a22b", "train_4k", "expert_2d",
         "REVISED after mb refutation (XLA hoists gathers; cost is per-layer "
         "full-size expert-grad all-reduces over data). Shard expert FFN dim "
         "over data too (E->model, F->data): weights fully 2D-sharded, so "
         "each chip reduces only its 1/16 F-slice — the reduce-scatter "
         "effect the CPU pipeline won't emit (predict collective ~x5 down)",
         dict(microbatches=8,
              rules=dict(DEFAULT_RULES, embed=None, ffn="data"),
              impl=_impl(loss_chunk=512, attn="xla_chunked"))),
    ],
}


def run_cell(cell: str, mesh=None, tags=None, art: str = ART) -> list[dict]:
    """Every experiment of ``cell`` (those in ``tags``, if given) on
    ``mesh``; None: a fake 256-rank world and the 16x16 production mesh,
    opened here and closed after."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    own = mesh is None
    if own:
        dryrun.init_fake_world(256)
    out = []
    try:
        if own:
            mesh = make_production_mesh(device_type="cpu")
        for arch, shape, tag, hypothesis, kw in EXPERIMENTS[cell]:
            if tags is not None and tag not in tags:
                continue
            t0 = time.time()
            try:
                rec = dryrun.lower_cell(arch, shape, mesh, **kw)
                rec.update(tag=tag, hypothesis=hypothesis, cell=cell)
                out.append(rec)
                print(f"[{cell}/{tag}] comp={rec['compute_s']:.3f}s "
                      f"mem={rec['memory_s']:.3f}s "
                      f"coll={rec['collective_s']:.3f}s "
                      f"dom={rec['dominant']} "
                      f"roof={100*rec['roofline_fraction']:.1f}% "
                      f"temp={rec['memory']['peak_step_bytes']/2**30:.1f}GiB "
                      f"({time.time()-t0:.0f}s)", flush=True)
            except Exception as e:  # noqa: BLE001 - record, go on
                print(f"[{cell}/{tag}] FAILED: {e!r}", flush=True)
                out.append({"cell": cell, "tag": tag,
                            "hypothesis": hypothesis, "error": repr(e),
                            "elapsed_s": round(time.time() - t0, 2)})
    finally:
        if own:
            dist.destroy_process_group()
    os.makedirs(art, exist_ok=True)
    with open(os.path.join(art, f"{cell}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv: list[str] | None = None) -> None:
    cells = (sys.argv[1:] if argv is None else argv) or list(EXPERIMENTS)
    for cell in cells:
        print(f"\n=== hillclimb {cell} ===")
        run_cell(cell)


if __name__ == "__main__":
    main()

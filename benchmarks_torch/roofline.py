"""Roofline table of the port's dry-run records.

    PYTHONPATH=src python -m benchmarks_torch.run roofline

The analog of ``benchmarks/roofline.py``: for each record under
``benchmarks_torch/artifacts/dryrun/{singlepod,multipod}/`` (written by
``python -m repro_torch.launch.dryrun``), the per-chip seconds a step of
compute, memory and collectives at H100 rates, the dominant term, the
roofline fraction (compute over the largest term), the useful FLOPs
fraction and memory per device, and one CSV row
``roofline/{mesh}/{arch}/{shape}``, compute µs, ``dom=...;roof=...%``.
The reference's memory per device is its compiled program's argument plus
temporary bytes; the port's record has no compiled program, so mem/dev is
its ``memory.bytes_per_device``: the local shards of parameters,
optimizer state and caches plus the step's peak (``peak_step_bytes``).
"""
from __future__ import annotations

import json
import os

from benchmarks_torch.common import ART, row

DRY = os.path.join(ART, "dryrun")


def load_cells(mesh_tag: str, root: str | None = None) -> list[dict]:
    d = os.path.join(root or DRY, mesh_tag)
    if not os.path.isdir(d):
        return []
    cells = []
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                cells.append(json.load(fh))
    return cells


def run(out: list[str], root: str | None = None) -> None:
    for mesh_tag in ("singlepod", "multipod"):
        cells = load_cells(mesh_tag, root)
        if not cells:
            print(f"# roofline: no {mesh_tag} artifacts "
                  f"(run python -m repro_torch.launch.dryrun first)")
            continue
        print(f"\n# Roofline ({mesh_tag}): per-chip seconds per step")
        print(f"{'arch':22s} {'shape':12s} {'comp_s':>9s} {'mem_s':>9s} "
              f"{'coll_s':>10s} {'dominant':>11s} {'roof%':>6s} "
              f"{'useful':>7s} {'mem/dev':>8s}")
        for c in cells:
            dom = c["dominant"].replace("_s", "")
            print(f"{c['arch']:22s} {c['shape']:12s} "
                  f"{c['compute_s']:9.3f} {c['memory_s']:9.3f} "
                  f"{c['collective_s']:10.3f} {dom:>11s} "
                  f"{100*c['roofline_fraction']:5.1f}% "
                  f"{c['useful_flops_frac']:7.2f} "
                  f"{c['memory']['bytes_per_device']/2**30:7.1f}G")
            out.append(row(
                f"roofline/{mesh_tag}/{c['arch']}/{c['shape']}",
                c["compute_s"] * 1e6,
                f"dom={dom};roof={100*c['roofline_fraction']:.1f}%"))

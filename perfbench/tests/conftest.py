"""Shared fixtures: a small cell written into a scratch checkout, and the
card check for tests marked ``chip``."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

SMALL_NODES = [
    {"count": 2, "gpu_type": "P100", "gpus": 8, "cpus": 64, "mem_gb": 512.0,
     "speed": 1.0},
    {"count": 1, "gpu_type": "V100", "gpus": 8, "cpus": 64, "mem_gb": 512.0,
     "speed": 1.5},
    {"count": 2, "gpu_type": "P100", "gpus": 2, "cpus": 16, "mem_gb": 128.0,
     "speed": 1.0}]


def small_config(predictor: bool) -> dict:
    """The Helios configuration on a 5-node cluster, with or without the
    predictor."""
    cfg = json.loads((ROOT / "perfbench" / "configs" /
                      "helios-pv-slice-pred.json").read_text())
    cfg["name"] = "small-pred" if predictor else "small"
    cfg["cluster"] = {"nodes": SMALL_NODES}
    cfg["profile"]["arrival_rate"] *= 3.0
    if not predictor:
        cfg["predictor"] = None
    return cfg


SMALL_TRAFFIC = {"rate_factor": 1.0, "num_jobs": 800,
                 "snapshot": {"min_pending": 300}, "trace_seeds": [5, 6],
                 "segment_passes": 40}


def write_cell(root: Path, cfg: dict, traffic: dict, cell: str) -> None:
    """Add a configuration, a traffic file and a cell to the checkout at
    ``root`` as a later change would: new files and new entries only."""
    (root / "perfbench" / "configs" / f"{cfg['name']}.json").write_text(
        json.dumps(cfg))
    (root / "perfbench" / "traffic" / f"{cell}.json").write_text(
        json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": cfg["name"], "source": "test",
                             "file": f"perfbench/configs/{cfg['name']}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": cfg["name"],
                               "traffic": cell, "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def checkout(tmp_path) -> Path:
    """A copy of the benchmark's files (``BENCHMARK.json`` and
    ``perfbench/``) with two small cells added: ``small-pred`` (with the
    predictor) and ``small`` (without)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    write_cell(tmp_path, small_config(True), SMALL_TRAFFIC, "small-pred")
    write_cell(tmp_path, small_config(False), SMALL_TRAFFIC, "small")
    return tmp_path


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, when
    the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)

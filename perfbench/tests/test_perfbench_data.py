"""The harness is driven by data: a new configuration, traffic mix and
per-layer metric are new files and new entries, found by name."""
from __future__ import annotations

import json

import torch

from perfbench import run


def test_new_cell_is_found_by_name(checkout):
    bench, cell, cfg, traffic = run.load_cell(checkout, "small-pred")
    assert cell["config"] == "small-pred" and cfg["name"] == "small-pred"
    assert traffic["trace_seeds"] == [5, 6]
    names = [m["name"] for m in run.cell_metrics(bench, "small-pred", True)]
    assert "predictor.ms_per_pass" in names


def test_new_metric_reader_is_found_by_name(checkout):
    (checkout / "perfbench" / "metrics" / "engine.passes_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['passes'])\n")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "engine.passes_seen", "unit": "passes",
                               "better": "higher", "source": "program_counter",
                               "layer": "engine", "moves": "jobs_per_s",
                               "workloads": ["small"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    torch.set_num_threads(1)
    result, _ = run.measure(checkout, "small", 11, 0.05, True,
                            torch.device("cpu"))
    assert result["correct"], result["compared"]
    assert result["metrics"]["engine.passes_seen"]["value"] == \
        result["attempted"]
    # a traced run on the CPU reads no device metric, and leaves it out
    assert "device.idle_pct" not in result["metrics"]


def test_benchmark_cells_name_existing_files():
    root = run.ROOT
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        _, _, cfg, traffic = run.load_cell(root, cell["name"])
        assert cfg["name"] == cell["config"]
        assert traffic["trace_seeds"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (root / "perfbench" / "metrics" / f"{m['name']}.py").exists()

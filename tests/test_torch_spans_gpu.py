"""The span recorder's copy counters on the card: the program's count of
host-device copies equals the profiler's ``Memcpy HtoD`` / ``DtoH`` count
outside the ranges where the test itself restores the engine and waits
for the device.

Needs a CUDA card and ``nvcc``: the test carries the ``gpu`` marker and
skips without a card.  Imports neither JAX nor the ``repro`` package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_spans_gpu.py
"""
import json
import math

import pytest
import torch

import repro_torch.sched as TS
from repro_torch.core import spans
from test_torch_spans import SMALL_PASSES, benchmark_snapshot

#: the test's own host ranges, whose copies are not the passes'
OUTSIDE = ("test.restore", "test.sync")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def profiler_copies(doc: dict) -> int:
    """``Memcpy HtoD`` / ``DtoH`` on the device whose host call lies
    outside the ``OUTSIDE`` ranges."""
    ev = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    outside = [(e["ts"], e["ts"] + e["dur"]) for e in ev
               if e.get("cat") == "user_annotation" and e["name"] in OUTSIDE]
    host = {e["args"]["correlation"]: e["ts"] for e in ev
            if e.get("cat") == "cuda_runtime"
            and "correlation" in e.get("args", {})}
    n = 0
    for e in ev:
        if e.get("cat") != "gpu_memcpy" or not (
                "HtoD" in e["name"] or "DtoH" in e["name"]):
            continue
        ts = host.get(e.get("args", {}).get("correlation"), e["ts"])
        n += not any(a <= ts < b for a, b in outside)
    return n


@pytest.mark.gpu
def test_copies_counted_match_the_profiler(cuda_device, tmp_path):
    torch.set_num_threads(1)
    spans.disable()
    blob = benchmark_snapshot(cuda_device)
    rf = torch.profiler.record_function
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    try:
        with prof:
            for _ in range(2):
                with rf("test.restore"):
                    # restored under the profiler: the recorder follows it
                    eng = TS.SchedulerEngine.load_state(blob)
                for _ in range(SMALL_PASSES):
                    eng.step(math.inf, max_events=1)
                with rf("test.sync"):
                    torch.cuda.synchronize(cuda_device)
            rec = spans.ACTIVE
    finally:
        spans.disable()
    assert rec is not None
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    c = rec.counters
    ours = c.get("device.h2d_copies", 0) + c.get("device.d2h_copies", 0)
    assert ours > 0 and c["rank.decisions"] > 0
    assert c["device.h2d_bytes"] > 0 and c["device.d2h_bytes"] > 0
    assert ours == profiler_copies(doc)

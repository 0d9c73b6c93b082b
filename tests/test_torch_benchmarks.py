"""The port's benchmarks run end to end on the CPU at tiny repeats (on the
card they default to ``--device cuda``).  Imports no JAX."""
import json
import math
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_latency_smoke():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "benchmarks_torch.bench_latency", "--device",
         "cpu", "--repeats", "2"], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["bench"] == "latency" and doc["device"] == "cpu"
    rows = doc["rows"]
    assert [r["queue"] for r in rows] == [128, 256, 512, 1024]
    for r in rows:
        for key in ("state_ms", "kernel_us", "plain_us", "decision_ms",
                    "milp_ms"):
            assert math.isfinite(r[key]) and r[key] > 0, (key, r)
        assert r["max_abs_err"] == 0.0       # on the CPU both are plain
        assert r["milp_used_solver"] and r["milp_ways"] >= 2
    assert "jax" not in out.stderr.lower()


def test_bench_latency_defaults_to_the_card(capsys):
    import benchmarks_torch.bench_latency as bench
    with pytest.raises(SystemExit):
        bench.main(["--help"])
    assert "(default cuda)" in capsys.readouterr().out


def test_bench_run_defaults_to_the_card(capsys):
    import benchmarks_torch.run as bench_run
    with pytest.raises(SystemExit):
        bench_run.main(["--help"])
    assert "(default cuda)" in capsys.readouterr().out

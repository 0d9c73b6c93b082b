"""The port's control-plane benches against the reference's on the CPU, at
smoke size: ``bench_preemption`` (``slo-lanes``, controller off / ``slo`` /
``slo+elastic``), ``bench_autoscaling`` (diurnal and flash-crowd, static /
``target-util`` / ``queue-pressure``), ``bench_federation`` (each fleet
scenario x each router), ``bench_obs`` (flash-crowd, obs off and on) and
``bench_chaos`` (``chaos-storm`` on ``milp``, chaos off / on with the strict
degradation ladder).  Each package writes its JSON document into a
temporary directory; the two must agree field for field once
``benchmarks_torch.common.CLOCK_FIELDS`` are taken out: provenance, ``host``,
``machine``, the obs artifacts' ``trace_path`` and ``prom_path`` (each
package writes its own), and the clock fields (``wall_s``, ``jobs_per_s``,
``lat_mean_ms``, ``lat_p99_ms``, ``p99_overhead``, ``p99_off_ms``,
``p99_on_ms``, ``mean_off_ms``, ``mean_on_ms`` and the obs verdicts
computed from them, ``within_bound`` and ``passed``).  Everything else is
compared exactly: completions, windows, routed counts, waits, JCTs,
utilization, fairness, deadline hit rates, preemptions, GPU-hours, scale
and lifecycle events, obs decisions and trace-event counts and the
obs-off bit identity, restarts, reclaims, MILP fallbacks and degraded
windows.  The CSV rows of the four benches without a clock in them are
compared whole.

Plus the port's analogs of the reference's ``--smoke`` subprocess tests and
``_registered`` tests (``tests/test_{lifecycle,autoscaling,federation,
chaos}.py``), run with ``--device cpu``.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke

from benchmarks import bench_autoscaling as j_auto
from benchmarks import bench_chaos as j_chaos
from benchmarks import bench_federation as j_fed
from benchmarks import bench_obs as j_obs
from benchmarks import bench_preemption as j_pre
from benchmarks_torch import bench_autoscaling as t_auto
from benchmarks_torch import bench_chaos as t_chaos
from benchmarks_torch import bench_federation as t_fed
from benchmarks_torch import bench_obs as t_obs
from benchmarks_torch import bench_preemption as t_pre
from conftest import SRC
from repro_torch.obs import validate_trace
from test_torch_host_benches import assert_same_doc, run_both

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = {"preemption": (j_pre, t_pre), "autoscaling": (j_auto, t_auto),
         "federation": (j_fed, t_fed), "chaos": (j_chaos, t_chaos)}


@pytest.fixture(autouse=True)
def one_thread():
    """torch's threads contend with JAX's in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bench", sorted(PAIRS))
def test_control_bench_matches_reference(monkeypatch, tmp_path, bench):
    jmod, tmod = PAIRS[bench]
    want, got, rows_ref, rows_port = run_both(monkeypatch, tmp_path, jmod,
                                              tmod)
    assert_same_doc(got, want)
    assert rows_port == rows_ref
    assert got["acceptance"] == want["acceptance"]
    for row in got["results"].values():
        assert row["completed"] == got["num_jobs"]
    # chip_smoke.py holds the card host's run to the reference's verdicts
    gates = chip_smoke.HOST_GATES[bench]
    assert {k: want["acceptance"][k] for k in gates} == gates


def test_bench_obs_matches_reference(monkeypatch, tmp_path):
    for mod, tag in ((j_obs, "ref"), (t_obs, "port")):
        monkeypatch.setattr(mod, "TRACE_PATH", str(tmp_path / f"{tag}.trace"))
        monkeypatch.setattr(mod, "PROM_PATH", str(tmp_path / f"{tag}.prom"))
    want, got, rows_ref, rows_port = run_both(monkeypatch, tmp_path, j_obs,
                                              t_obs)
    assert_same_doc(got, want)
    assert [r.split(",")[0] for r in rows_port] == \
        [r.split(",")[0] for r in rows_ref]
    assert got["acceptance"]["obs_off_bit_identical"] is True
    assert got["trace_events"] > 0 and got["num_jobs"] == t_obs.SMOKE_JOBS
    trace = json.loads((tmp_path / "port.trace").read_text())
    assert validate_trace(trace) == []
    assert len(trace["traceEvents"]) == got["trace_events"]

    def counters(path):
        """The Prometheus text's counter samples (no clock reads them)."""
        return sorted(line for line in path.read_text().splitlines()
                      if line.split("{")[0].split(" ")[0].endswith("_total"))
    port_counters = counters(tmp_path / "port.prom")
    assert any(c.startswith("repro_decisions_total") for c in port_counters)
    assert port_counters == counters(tmp_path / "ref.prom")


def _finite_rows(doc: dict, n: int) -> None:
    for row in doc["results"].values():
        assert row["completed"] == n
        for v in row.values():
            if isinstance(v, float):
                assert math.isfinite(v)


SMOKE = {
    # bench: (jobs env, JSON env, acceptance keys)
    "preemption": ("REPRO_BENCH_PREEMPT_JOBS", "REPRO_BENCH_PREEMPT_JSON",
                   ("slo_lanes_improves_hit_rate",
                    "slo_lanes_wait_within_band")),
    "autoscaling": ("REPRO_BENCH_AUTOSCALE_JOBS", "REPRO_BENCH_AUTOSCALE_JSON",
                    ("diurnal_cuts_gpu_hours", "diurnal_wait_within_band",
                     "flash_crowd_cuts_gpu_hours",
                     "flash_crowd_wait_within_band")),
    "federation": ("REPRO_BENCH_FED_JOBS", "REPRO_BENCH_FED_JSON",
                   ("jsq_beats_hash", "sku_affinity_beats_hash")),
    "chaos": ("REPRO_BENCH_CHAOS_JOBS", "REPRO_BENCH_CHAOS_JSON",
              ("wait_within_band", "ladder_fired")),
}


@pytest.mark.parametrize("bench", sorted(SMOKE))
def test_bench_smoke_subprocess(tmp_path, bench):
    """The port's bench runs end to end as a module in ``--smoke`` mode on
    the CPU and writes a well-formed acceptance block (the analogs of
    ``tests/test_{lifecycle,autoscaling,federation,chaos}.py``'s
    ``test_bench_*_smoke``)."""
    jobs_env, json_env, keys = SMOKE[bench]
    n = 150 if bench == "autoscaling" else 120
    json_path = tmp_path / f"BENCH_{bench}.json"
    env = dict(os.environ, **{jobs_env: str(n), json_env: str(json_path)})
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", f"benchmarks_torch.bench_{bench}", "--smoke",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    doc = json.loads(json_path.read_text())
    assert doc["bench"] == bench and doc["num_jobs"] == n
    assert doc["scale"] == "smoke" and doc["provenance"]["device"] == "host"
    for k in keys:
        assert k in doc["acceptance"], k
    if bench == "chaos":
        assert doc["acceptance"]["milp_fallbacks"] > 0
    _finite_rows(doc, n)


@pytest.mark.parametrize("bench", ["preemption", "autoscaling", "federation",
                                   "obs", "chaos"])
def test_control_bench_registered(bench):
    from benchmarks_torch import run as bench_run
    assert bench in bench_run.MODULES

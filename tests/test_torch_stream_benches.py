"""The port's stream benches against the reference's on the CPU, at smoke
size: ``bench_prediction`` (blind against predictor-assisted backfill on
four scenarios) and ``bench_rl_streaming`` (streaming-trained against
batch-trained against FCFS on three).  Each package writes its JSON
document into a temporary directory; the two documents must agree field
for field once the provenance and the wall-clock fields (``wall_s``,
``jobs_per_s``, ``*_train_s``) are masked.  MAPE fields are held to
``RTOL_QUANTILES`` (1e-6 relative, ``tests/test_torch_predict.py``'s bound
on the predictor's quantiles: the batched forward sums in another order);
every other field exactly.

For ``bench_rl_streaming`` every port agent starts from the reference
agent's initial weights for its ``PPOConfig`` and samples with the
reference's Gumbel draws (one ``jax.random`` chain per agent, as the
reference's agents draw), as ``test_torch_rl.py``'s ``inject`` does for one
agent.  Plus the port's analog of ``tests/test_rl_streaming.py``'s smoke
subprocess."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core.agent as JA
import repro_torch.core.agent as TA
from benchmarks import bench_prediction as j_pred
from benchmarks import bench_rl_streaming as j_rl
from benchmarks_torch import bench_prediction as t_pred
from benchmarks_torch import bench_rl_streaming as t_rl
from benchmarks_torch.common import DEVICE_ENV
from conftest import SRC
from repro_torch.core.features import MAX_QUEUE_SIZE
from test_torch_predict import RTOL_QUANTILES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALL_FIELDS = ("wall_s", "jobs_per_s", "streaming_train_s", "batch_train_s")
MAPE_FIELDS = ("mape_mlp", "mape_baseline")


@pytest.fixture(autouse=True)
def one_thread():
    """torch's threads contend with JAX's in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masked(doc: dict) -> dict:
    """The document without its provenance and wall-clock fields."""
    def walk(d):
        return {k: walk(v) if isinstance(v, dict) else v
                for k, v in d.items() if k not in WALL_FIELDS}
    return walk({k: v for k, v in doc.items() if k != "provenance"})


def _assert_same_doc(got: dict, want: dict) -> None:
    got, want = _masked(got), _masked(want)

    def walk(g, w, path):
        assert isinstance(g, dict) == isinstance(w, dict), path
        if not isinstance(w, dict):
            if path[-1] in MAPE_FIELDS:
                assert np.isclose(g, w, rtol=RTOL_QUANTILES, atol=0), (path, g, w)
            else:
                assert g == w, (path, g, w)
            return
        assert sorted(g) == sorted(w), path
        for k in w:
            walk(g[k], w[k], path + (k,))
    walk(got, want, ())


def _run_both(monkeypatch, tmp_path, jmod, tmod):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.setattr(jmod, "JSON_PATH", str(tmp_path / "ref.json"))
    monkeypatch.setattr(tmod, "JSON_PATH", str(tmp_path / "port.json"))
    rows_ref: list[str] = []
    rows_port: list[str] = []
    want = jmod.run(rows_ref, smoke=True)
    got = tmod.run(rows_port, smoke=True)
    assert json.loads((tmp_path / "ref.json").read_text()) == want
    assert json.loads((tmp_path / "port.json").read_text()) == got
    return want, got, rows_ref, rows_port


def test_bench_prediction_matches_reference(monkeypatch, tmp_path):
    want, got, rows_ref, rows_port = _run_both(monkeypatch, tmp_path, j_pred,
                                               t_pred)
    _assert_same_doc(got, want)
    assert rows_port == rows_ref
    assert set(got["results"]) == {f"{s}/{a}" for s in t_pred.SCENARIOS
                                   for a in ("blind", "assisted")}
    prov = got["provenance"]
    assert prov["torch"] == torch.__version__ and prov["device"] == "cpu"
    assert prov["card"] is None and prov["nvidia_smi"] is None
    assert "jax" not in prov


@pytest.fixture
def reference_agents(monkeypatch):
    """Every port ``PPOAgent`` starts from the reference agent's initial
    weights for its config and samples with that agent's Gumbel draws.
    Returns the actions taken, ``{"ref": [...], "port": [...]}``."""
    actions = {"ref": [], "port": []}
    real_ref, real_port = JA.policy_step, TA.policy_step
    real_init = TA.PPOAgent.__init__
    chains: dict[int, list] = {}

    def init(self, cfg=None, **kwargs):
        real_init(self, cfg, **kwargs)
        ref = JA.PPOAgent(JA.PPOConfig(**dataclasses.asdict(self.cfg)))
        self.load_state_dict(ref.state_dict())
        chains[id(self._gen)] = [jax.random.PRNGKey(self.cfg.seed + 1)]

    def ref_step(params, ov, cv, mask, key):
        out = real_ref(params, ov, cv, mask, key)
        g = np.array(jax.random.gumbel(key, (MAX_QUEUE_SIZE,)))
        assert int(np.argmax(np.asarray(out["logits"]) + g)) == \
            int(out["action"])
        actions["ref"].append(int(out["action"]))
        return out

    def port_step(net, ov, cv, mask, generator=None, gumbel=None):
        chain = chains[id(generator)]
        chain[0], sub = jax.random.split(chain[0])
        g = torch.from_numpy(np.array(jax.random.gumbel(
            sub, (MAX_QUEUE_SIZE,)))).to(ov.device)
        out = real_port(net, ov, cv, mask, gumbel=g)
        actions["port"].append(int(out["action"]))
        return out

    monkeypatch.setattr(TA.PPOAgent, "__init__", init)
    monkeypatch.setattr(JA, "policy_step", ref_step)
    monkeypatch.setattr(TA, "policy_step", port_step)
    return actions


def test_bench_rl_streaming_matches_reference(monkeypatch, tmp_path,
                                              reference_agents):
    want, got, rows_ref, rows_port = _run_both(monkeypatch, tmp_path, j_rl,
                                               t_rl)
    acts = reference_agents
    assert len(acts["port"]) > 0 and acts["port"] == acts["ref"]
    _assert_same_doc(got, want)
    assert rows_port == rows_ref
    assert got["acceptance"]["passed"] == want["acceptance"]["passed"]


def test_run_py_registers_the_port_benches():
    from benchmarks_torch import run as bench_run
    for name in ("latency", "variability", "naive", "util", "transfer",
                 "qssf", "policies", "prediction", "rl_streaming"):
        assert name in bench_run.MODULES


def test_bench_rl_streaming_smoke_subprocess(tmp_path):
    """The port's RL bench runs end to end as a module in --smoke mode on
    the CPU and writes a valid acceptance block (the analog of
    ``tests/test_rl_streaming.py::test_bench_rl_streaming_smoke``)."""
    out_json = tmp_path / "BENCH_rl_streaming.json"
    env = dict(os.environ, REPRO_BENCH_RL_JSON=str(out_json),
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "benchmarks_torch.bench_rl_streaming",
         "--smoke", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    doc = json.loads(out_json.read_text())
    assert doc["scale"] == "smoke"
    assert set(doc["results"]) == {"flash-crowd", "diurnal", "sku-skew"}
    for row in doc["results"].values():
        assert set(row) == {"streaming", "batch", "fcfs"}
    acc = doc["acceptance"]
    assert "scenarios_beaten" in acc and "passed" in acc
    assert doc["provenance"]["device"] == "cpu"

"""The port's examples (``examples_torch/``) against the reference's
(``examples/``) on the CPU.  Each reference example is loaded from its file
and run through its own ``main`` (``sys.argv`` set), with its classes
wrapped to record what it computes; each port example runs through
``main(argv)`` with ``--device cpu``.

- ``quickstart`` at tiny sizes (2 batches of 32): the ``base`` arm of the
  evaluation equals the reference's exactly; with the reference trainer's
  trained agent carried across (``state_dict``) the ``rl`` arm does too.
  The training itself samples from ``jax.random`` in the reference, which
  the port cannot draw.
- ``cluster_failover`` with training cut to one batch pair in both: the
  ``fcfs`` ``BatchResult`` equals the reference's, and the ``rltune`` one
  under the reference's trained weights.  The port's cost model times the
  platform jobs at H100 rates; here it takes the reference's rates, as
  ``test_torch_dryrun.py::test_platform_trace_matches_reference_at_
  reference_rates`` does, so both examples schedule the same jobs.
- ``serve_lm`` for ``yi-6b`` and ``jamba-v0.1-52b``: the smoke config in
  f32 with the reference's ``PRNGKey(0)`` parameters carried across
  (``convert.lm_params_from_jax``) gives the reference's requests token for
  token, as ``tests/test_torch_serve.py`` holds the engine.
- ``train_lm``: the reference's ``train_loop`` fails on this JAX version
  (ROADMAP Queue 3), so its loop is rebuilt as
  ``test_torch_lm_train.py::test_train_loop_matches_reference_loop`` does
  (its ``make_train_step`` with microbatches 2, ``OptConfig`` rule and
  ``SyntheticLMDataset``) from the port example's seeded weights: the
  example's losses within ``LOOP_TOL``, its first gradient norm within
  ``GNORM_RTOL``.  A ``--steps 2 --device cpu``
  subprocess exits 0 with its loss-falls assertion (2 is the smallest
  count at which the seeded loss falls: one step has no last loss to
  compare, and the CPU run is deterministic).
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.costmodel as JC
import repro.core.trainer as j_trainer
import repro_torch.core.costmodel as TC
import repro_torch.launch.roofline as TR
from conftest import SRC
from examples_torch import cluster_failover, quickstart, serve_lm, train_lm
from repro.configs.base import ModelConfig as JModelConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.models.lm import LM as JLM
from repro.models.lm import ModelImpl as JImpl
from repro.train import OptConfig as JOptConfig
from repro.train import make_train_step as jmake_train_step
from repro.train import opt_init as jopt_init
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import lm_params_from_jax
from test_torch_lm_train import LOOP_TOL, _to_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the first step's global gradient norm, port against the rebuilt
# reference loop (bf16: 3.2e-2 apart, f32: 7e-4; after the first update the
# runs part further, since Adam's first steps move each weight by about lr
# whatever its gradient's size, and near-zero gradients take their sign
# from the rounding)
GNORM_RTOL = 5e-2


@pytest.fixture(autouse=True)
def one_thread():
    """torch's threads contend with JAX's in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_example(name: str, monkeypatch, *argv: str):
    """The reference's ``examples/NAME.py`` as a module, with ``sys.argv``
    set for its ``main``."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(REPO, "examples",
                                                  f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return mod


def recording(cls, log: dict, train_batches: int | None = None):
    """A subclass of a trainer class that records its instance and its
    evaluations, and trains ``train_batches`` batch pairs when given."""
    class Recorded(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            log["trainer"] = self

        def train(self, *a, **kw):
            if train_batches is not None:
                kw["batches_per_epoch"] = train_batches
            return super().train(*a, **kw)

        def evaluate(self, *a, **kw):
            log["eval"] = super().evaluate(*a, **kw)
            return log["eval"]
    return Recorded


def carried(ref_log: dict, cls):
    """A subclass of the port's trainer whose agent takes the reference
    trainer's trained weights once its own training is done."""
    class Carried(cls):
        def train(self, *a, **kw):
            out = super().train(*a, **kw)
            self.agent.load_state_dict(ref_log["trainer"].agent.state_dict())
            return out
    return Carried


def test_quickstart_matches_reference(monkeypatch):
    args = ("--batches", "2", "--batch-size", "32")
    ref = reference_example("quickstart", monkeypatch, *args)
    ref_log: dict = {}
    monkeypatch.setattr(ref, "RLTuneTrainer",
                        recording(j_trainer.RLTuneTrainer, ref_log))
    ref.main()
    monkeypatch.setattr(quickstart, "RLTuneTrainer",
                        carried(ref_log, quickstart.RLTuneTrainer))
    ev = quickstart.main([*args, "--device", "cpu"])
    assert ev["base"] == ref_log["eval"]["base"]
    assert ev["rl"] == ref_log["eval"]["rl"]
    assert all(np.isfinite(v) for side in ev.values() for v in side.values())


def batch_sig(res) -> tuple:
    return ((res.makespan, res.total_wait, res.gpu_seconds_used,
             res.decisions, res.milp_calls, res.backfills, res.restarts),
            sorted((j.job_id, j.start_time, j.finish_time, j.restarts)
                   for j in res.jobs))


def test_cluster_failover_matches_reference(monkeypatch, tmp_path):
    monkeypatch.setattr(TC, "_ARTIFACTS", str(tmp_path))
    monkeypatch.setattr(TC, "SKU_SPEED", dict(JC.SKU_SPEED))
    monkeypatch.setattr(TR, "PEAK_FLOPS_BF16", 197e12)
    monkeypatch.setattr(TR, "HBM_BW", 819e9)
    monkeypatch.setattr(TR, "NVLINK_BW", 50e9)
    ref = reference_example("cluster_failover", monkeypatch)
    ref_log: dict = {}
    ref_results: list = []

    class RecordedSimulator(ref.Simulator):
        def run_batch(self, *a, **kw):
            ref_results.append(super().run_batch(*a, **kw))
            return ref_results[-1]

    monkeypatch.setattr(ref, "RLTuneTrainer",
                        recording(j_trainer.RLTuneTrainer, ref_log,
                                  train_batches=1))
    monkeypatch.setattr(ref, "Simulator", RecordedSimulator)
    ref.main()
    port_log: dict = {}
    monkeypatch.setattr(cluster_failover, "RLTuneTrainer", carried(
        ref_log, recording(cluster_failover.RLTuneTrainer, port_log,
                           train_batches=1)))
    got = cluster_failover.main(["--device", "cpu"])
    assert port_log["trainer"].agent.device.type == "cpu"
    want = dict(zip(("fcfs", "rltune"), ref_results))
    assert set(got) == set(want)
    assert batch_sig(got["fcfs"]) == batch_sig(want["fcfs"])
    assert batch_sig(got["rltune"]) == batch_sig(want["rltune"])
    assert got["rltune"].restarts > 0 or got["fcfs"].restarts > 0


@pytest.mark.parametrize("arch", ["yi-6b", "jamba-v0.1-52b"])
def test_serve_lm_matches_reference(monkeypatch, arch):
    ref = reference_example("serve_lm", monkeypatch, "--arch", arch)
    real_get = ref.get_config
    monkeypatch.setattr(ref, "get_config", lambda name, smoke=False:
                        dataclasses.replace(real_get(name, smoke),
                                            dtype=jnp.float32))
    seen: dict = {}

    class RecordedEngine(ref.ServeEngine):
        def __init__(self, model, params, **kw):
            super().__init__(model, params, **kw)
            seen["params"] = params

        def run(self, reqs):
            seen["done"] = super().run(reqs)
            return seen["done"]

    monkeypatch.setattr(ref, "ServeEngine", RecordedEngine)
    ref.main()
    monkeypatch.setattr(serve_lm, "get_config", lambda name, smoke=False:
                        dataclasses.replace(tget_config(name, smoke),
                                            dtype=torch.float32))
    real_build = serve_lm.build_model

    def build(cfg, **kw):
        model = real_build(cfg, **kw)
        params = lm_params_from_jax(jax.tree.map(np.asarray, seen["params"]),
                                    model)
        model.init = lambda seed: params
        return model

    monkeypatch.setattr(serve_lm, "build_model", build)
    got = serve_lm.main(["--arch", arch, "--device", "cpu"])
    want = seen["done"]
    assert [r.req_id for r in got] == [r.req_id for r in want]
    assert [r.prompt for r in got] == [[int(t) for t in r.prompt]
                                       for r in want]
    for g, w in zip(got, want):
        assert len(g.output) == 8
        assert g.output == [int(t) for t in w.output], g.req_id


def reference_loop(cfg, steps: int, perturb: float = 0.0) -> tuple[list, list]:
    """The reference's loop rebuilt (its ``make_train_step`` with
    microbatches 2, ``OptConfig`` rule for ``steps`` and
    ``SyntheticLMDataset``, the example's batch, sequence and lr) from the
    port example's seeded weights, each times 1 + ``perturb`` N(0, 1):
    (losses, global gradient norms)."""
    jc = JModelConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg) if f.name != "dtype"},
                      dtype=jnp.dtype(str(cfg.dtype).removeprefix("torch.")))
    tm = train_lm.build_model(cfg, device="cpu")
    jp = _to_reference(tm.init(0))
    if perturb:
        leaves, tree = jax.tree.flatten(jp)
        keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
        jp = jax.tree.unflatten(tree, [
            (x * (1 + perturb * jax.random.normal(k, x.shape))).astype(x.dtype)
            for x, k in zip(leaves, keys)])
    jstep = jax.jit(jmake_train_step(JLM(jc, JImpl()), JOptConfig(
        lr=3e-3, warmup_steps=max(steps // 10, 5), total_steps=steps),
        microbatches=2))
    jopt = jopt_init(jp)
    ds = JDataset(jc.vocab_size, 256, 8, seed=0)
    losses, gnorms = [], []
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in ds.batch_at(i).items()}
        jp, jopt, m = jstep(jp, jopt, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    return losses, gnorms


def test_train_lm_matches_reference_loop():
    steps = 2
    out = train_lm.main(["--steps", str(steps), "--device", "cpu"])
    want, want_gnorms = reference_loop(train_lm.QUICK, steps)
    assert len(out["losses"]) == steps and out["start_step"] == 0
    np.testing.assert_allclose(out["losses"], want, rtol=0, atol=LOOP_TOL)
    np.testing.assert_allclose(out["gnorms"][0], want_gnorms[0],
                               rtol=GNORM_RTOL)
    assert out["final_loss"] < out["losses"][0]


def test_train_lm_subprocess_loss_falls():
    env = dict(os.environ,
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join("examples_torch", "train_lm.py"),
         "--steps", "2", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "[train_lm] example-15m" in r.stdout and "loss" in r.stdout


@pytest.mark.parametrize("name", ["quickstart", "cluster_failover", "serve_lm",
                                  "train_lm"])
def test_example_defaults_to_the_card(name, monkeypatch):
    """Without ``--device`` an example runs on the card, and raises where
    there is none (no CPU route)."""
    mod = __import__(f"examples_torch.{name}", fromlist=["main"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])


if __name__ == "__main__":
    # example-100m (``train_lm --full``) through both loops on the CPU from
    # the same seeded weights, each step's loss and gradient norm, and the
    # reference's from those weights perturbed by a relative --perturb:
    # PYTHONPATH=src:. python tests/test_torch_examples.py [STEPS] [--f32]
    # [--perturb EPS] [--reference-only]
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", type=int, nargs="?", default=3)
    ap.add_argument("--f32", action="store_true",
                    help="both in float32 (the example trains in bfloat16)")
    ap.add_argument("--perturb", type=float, default=1e-7)
    ap.add_argument("--reference-only", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    cfg = train_lm.FULL
    if args.f32:
        cfg = dataclasses.replace(cfg, name="example-100m-f32",
                                  dtype=torch.float32)
    n = args.steps
    port = {"losses": [float("nan")] * n, "gnorms": [float("nan")] * n}
    if not args.reference_only:
        train_lm.register(cfg, cfg)
        port = train_lm.train_loop(cfg.name, steps=n, batch=8, seq=256,
                                   microbatches=2, lr=3e-3, device="cpu",
                                   log_every=n + 1)
    ref_losses, ref_gnorms = reference_loop(cfg, n)
    alt_losses, alt_gnorms = (reference_loop(cfg, n, args.perturb)
                              if args.perturb else ([float("nan")] * n,) * 2)
    for i in range(n):
        print(f"step {i}: loss port {port['losses'][i]:.6f} reference "
              f"{ref_losses[i]:.6f} perturbed {alt_losses[i]:.6f}; gnorm "
              f"port {port['gnorms'][i]:.6e} reference {ref_gnorms[i]:.6e} "
              f"perturbed {alt_gnorms[i]:.6e}", flush=True)

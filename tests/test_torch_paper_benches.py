"""The port's paper benches (``benchmarks_torch``) against the reference's
(``benchmarks``) on the CPU: Fig 6, Fig 10, Table 6 and Table 7 here,
Table 8 / Fig 17 and Table 9 / Figs 11-16 in
``test_torch_paper_benches_policies.py``.

Both packages' ``common.AGENTS`` point at one temporary directory, with one
training batch pair per agent and one evaluation batch (the knobs
``REPRO_BENCH_TRAIN_BATCHES`` / ``REPRO_BENCH_EVAL_BATCHES`` set, batches of
128 as at the quick scale).  The reference's ``run(rows)`` goes first: it
trains each agent in JAX and caches it (in zlib, the reference's
minimal-install codec; the card's host has no ``zstandard``).  The port's
``run(rows)`` then runs on the CPU, loads those agents through its own
``load_checkpoint`` (training none: it prints no "trained" line) and
evaluates them greedily: its CSV rows must be the reference's, string for
string.  Training itself cannot match (the reference samples with
``jax.random``); it is held with injected draws in ``test_torch_rl.py``.
"""
import importlib

import numpy as np
import pytest
import torch

import benchmarks.common as JC
import benchmarks_torch.common as TC
from repro.ckpt import checkpoint as jckpt_mod

TRAIN_BATCHES = 1
EVAL_BATCHES = 1


@pytest.fixture(autouse=True)
def one_thread():
    """torch's threads contend with JAX's in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def benches(tmp_path, monkeypatch):
    """``benches(name)`` -> (reference module, port module) of
    ``bench_<name>``, both at the knobs above, on one agent cache, the port
    on the CPU and the reference writing zlib."""
    monkeypatch.setenv(TC.DEVICE_ENV, "cpu")
    monkeypatch.setattr(jckpt_mod, "_zstd", None)
    monkeypatch.setattr(jckpt_mod, "_CODEC", "zlib")
    for mod in (JC, TC):
        monkeypatch.setattr(mod, "AGENTS", str(tmp_path / "agents"))
        monkeypatch.setattr(mod, "TRAIN_BATCHES", TRAIN_BATCHES)
        monkeypatch.setattr(mod, "EVAL_BATCHES", EVAL_BATCHES)

    def load(name):
        mods = (importlib.import_module(f"benchmarks.bench_{name}"),
                importlib.import_module(f"benchmarks_torch.bench_{name}"))
        for mod in mods:
            if hasattr(mod, "EVAL_BATCHES"):
                monkeypatch.setattr(mod, "EVAL_BATCHES", EVAL_BATCHES)
        return mods
    return load


def run_both(benches, capsys, name) -> tuple[list[str], list[str]]:
    """(reference rows, port rows) of ``bench_<name>``; the port must load
    every agent it uses from the reference's cache."""
    jmod, tmod = benches(name)
    want: list[str] = []
    jmod.run(want)
    capsys.readouterr()
    got: list[str] = []
    tmod.run(got)
    assert "#   trained" not in capsys.readouterr().out
    return want, got


@pytest.mark.parametrize("name", ["variability", "naive_vs_pro", "util",
                                  "transfer"])
def test_paper_bench_rows_are_the_reference_rows(benches, capsys, name):
    want, got = run_both(benches, capsys, name)
    assert len(want) > 0
    assert got == want


def _params_equal(a: dict, b: dict) -> bool:
    return all(np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
               for net in a["params"]
               for x, y in zip(a["params"][net], b["params"][net])
               for k in ("w", "b"))


def test_cache_miss_trains_saves_and_reloads(benches, capsys):
    """A cache miss in the port trains the agent and saves its weights; the
    next call loads the same weights without training, and the reference's
    ``get_trainer`` and ``load_checkpoint`` read the port's save."""
    from repro.ckpt import load_checkpoint as jload
    from repro.ckpt.checkpoint import latest_step as jlatest
    key = ("helios", "sjf", "wait", "pro")
    trained = TC.get_trainer(*key)
    assert "trained helios/sjf/wait/pro" in capsys.readouterr().out
    path = TC.agent_path(*key)
    assert jlatest(path) == 1
    want = trained.agent.state_dict()
    fresh = TC.get_trainer(*key, train=False).agent.state_dict()
    assert not _params_equal(fresh, want)          # training moved them
    again = TC.get_trainer(*key)
    assert "#   trained" not in capsys.readouterr().out
    assert _params_equal(again.agent.state_dict(), want)
    ref = JC.get_trainer(*key)
    assert "#   trained" not in capsys.readouterr().out
    assert _params_equal(ref.agent.state_dict(), want)
    state, step = jload(path, ref.agent.state_dict())
    assert step == 1 and _params_equal(state, want)
    # the cached agent evaluates as the reference's does on the same weights
    assert TC.eval_pair(again) == JC.eval_pair(ref)

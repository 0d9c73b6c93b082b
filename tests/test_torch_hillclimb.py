"""The port's hillclimb (``benchmarks_torch.hillclimb``) against the
reference's (``benchmarks/hillclimb.py``), on the CPU.

- ``EXPERIMENTS`` is the reference's: the same cells, tags, hypotheses,
  rule sets and microbatches, and every ``ModelImpl`` the reference's on
  the port's plain paths (``ssd="xla"``, ``moe="xla"``, the reference's
  ``attn``).  The reference's list is read in a subprocess: importing
  ``benchmarks/hillclimb.py`` sets ``XLA_FLAGS`` to 512 host devices.
- A tiny run of every cell on a fake 2x2 world, the smoke configs and a
  64 x 256 ``train_4k`` patched in: each record's analytic FLOPs and HBM
  bytes are the reference's ``analytic_cost`` at that experiment's
  microbatches, the records go to ``{cell}.json``, and an experiment that
  raises is recorded with its ``error`` while the cell goes on.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

import benchmarks_torch.hillclimb as hc
from conftest import REPO, SRC
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShape
from repro.launch.roofline import analytic_cost as janalytic
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh

_READ = r'''
import dataclasses, json
from benchmarks.hillclimb import EXPERIMENTS
def enc(kw):
    out = {}
    for k, v in kw.items():
        if k == "rules":
            v = {a: (list(b) if isinstance(b, tuple) else b) for a, b in v.items()}
        elif k == "impl":
            v = dataclasses.asdict(v)
        out[k] = v
    return out
print(json.dumps({c: [[a, s, t, h, enc(kw)] for a, s, t, h, kw in exps]
                  for c, exps in EXPERIMENTS.items()}))
'''


def _encode(kw: dict) -> dict:
    out = {}
    for k, v in kw.items():
        if k == "rules":
            v = {a: (list(b) if isinstance(b, tuple) else b)
                 for a, b in v.items()}
        elif k == "impl":
            v = dataclasses.asdict(v)
        out[k] = v
    return out


@pytest.fixture(scope="module")
def reference_list():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + REPO)
    out = subprocess.run([sys.executable, "-c", _READ], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_experiments_are_the_references(reference_list):
    assert list(hc.EXPERIMENTS) == list(reference_list) == \
        ["mamba2", "yi", "qwen3"]
    assert [len(v) for v in hc.EXPERIMENTS.values()] == [4, 6, 5]
    for cell, exps in hc.EXPERIMENTS.items():
        ref = reference_list[cell]
        assert len(exps) == len(ref)
        for (arch, shape, tag, hyp, kw), (ja, js, jt, jh, jkw) in zip(exps, ref):
            assert (arch, shape, tag, hyp) == (ja, js, jt, jh)
            mine = _encode(kw)
            assert set(mine) == set(jkw), tag
            for k in ("rules", "microbatches"):
                assert mine.get(k) == jkw.get(k), (cell, tag, k)
            if "impl" in jkw:
                got, want = mine["impl"], jkw["impl"]
                assert got["attn"] == want["attn"] in ("xla", "xla_chunked")
                assert got["ssd"] == "xla" and got["moe"] == "xla"
                for f in ("remat", "remat_policy", "loss_chunk"):
                    assert got[f] == want[f], (cell, tag, f)
                assert not want["scan_unroll"]


def test_expert_2d_rules():
    rules = hc.EXPERIMENTS["qwen3"][-1][4]["rules"]
    assert rules["embed"] is None and rules["ffn"] == "data"
    from repro_torch.sharding.specs import DEFAULT_RULES
    assert {k: v for k, v in rules.items() if k not in ("embed", "ffn")} == \
        {k: v for k, v in DEFAULT_RULES.items() if k not in ("embed", "ffn")}


SHAPE = (256, 64)              # seq, global batch of the tiny train_4k


@pytest.fixture
def tiny(monkeypatch):
    """A fake 2x2 world, the smoke configs and a 64 x 256 train_4k."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch, smoke=False: get_config(arch, smoke=True))
    monkeypatch.setitem(dryrun.SHAPES, "train_4k",
                        ShapeConfig("train_4k", SHAPE[0], SHAPE[1], "train"))
    dryrun.init_fake_world(4)
    yield make_host_mesh(model=2, device_type="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("cell", ["mamba2", "yi", "qwen3"])
def test_tiny_cell_holds_the_reference_analytic_cost(tiny, tmp_path, cell):
    recs = hc.run_cell(cell, mesh=tiny, art=str(tmp_path))
    assert json.loads((tmp_path / f"{cell}.json").read_text()) == recs
    assert [r["tag"] for r in recs] == [e[2] for e in hc.EXPERIMENTS[cell]]
    jshape = JShape("train_4k", SHAPE[0], SHAPE[1], "train")
    for rec, (arch, _, tag, _, kw) in zip(recs, hc.EXPERIMENTS[cell]):
        assert "error" not in rec, (tag, rec.get("error"))
        assert rec["cell"] == cell and rec["chips"] == 4
        mb = kw.get("microbatches", dryrun.TRAIN_MICROBATCHES[arch])
        assert rec["microbatches"] == mb
        jcfg = jget_config(arch, smoke=True)
        ana = janalytic(jcfg, jshape, microbatches=mb, remat=True, chips=4,
                        model=JLM(jcfg))
        for k in ("flops_per_chip", "flops_global", "hbm_bytes_per_chip"):
            assert rec[k] == ana[k], (tag, k)
        assert rec["memory"]["peak_step_bytes"] > 0


def test_a_raising_experiment_is_recorded(tiny, tmp_path, monkeypatch):
    """tp_only raises: it is recorded with its error and the cell goes on
    to the next two experiments."""
    real = dryrun.lower_cell

    def lower(arch, shape, mesh, rules=None, **kw):
        if rules is hc.TP_ONLY_RULES and "microbatches" not in kw:
            raise RuntimeError("planted")
        return real(arch, shape, mesh, rules=rules, **kw)
    monkeypatch.setattr(dryrun, "lower_cell", lower)
    recs = hc.run_cell("mamba2", mesh=tiny, art=str(tmp_path))
    assert [r["tag"] for r in recs] == ["baseline", "tp_only", "tp_only_mb1",
                                        "dp_only_mb1"]
    assert recs[1]["error"] == "RuntimeError('planted')"
    assert recs[1]["elapsed_s"] >= 0
    assert all("error" not in r for i, r in enumerate(recs) if i != 1)

"""The port's distributed pieces on the card.  Needs a CUDA card: every test
here carries the ``gpu`` marker and skips without one.  It imports neither
JAX nor the ``repro`` package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_dist_gpu.py

- A world of 1 over NCCL (a subprocess, which owns its process group): one
  ``shard_train_step`` step of the granite smoke config in f32 on the 1x1
  host mesh against the unsharded ``make_train_step`` on the card.  On one
  rank every shard is the whole tensor and the same kernels run in the same
  order, so the loss, gradient norm and updated parameters are equal bit
  for bit.
- Four ranks on the one card over ``gloo``: ``pod_allreduce_compressed`` on
  CUDA tensors equals a numpy evaluation of its formula bit for bit.
- Where there are four cards, a 2x2 mesh over NCCL: the sharded step,
  the compressed all-reduce and GPipe across the cards (skipped on one
  card).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.ranks import run_ranks
from repro_torch.train.compression import pod_allreduce_formula

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

_NCCL1 = r'''
import dataclasses, json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import LM, ModelImpl
from repro_torch.sharding.specs import DEFAULT_RULES
from repro_torch.train import OptConfig, make_train_step, opt_init
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.step import shard_train_step
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_device(0)
dist.init_process_group("nccl")
mesh = make_host_mesh()
cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True),
                          dtype=torch.float32)
impl = ModelImpl(attn="xla", ssd="xla", moe="xla")
opt = OptConfig(lr=1e-3, warmup_steps=1)
batch = {k: torch.from_numpy(v).cuda() for k, v in
         SyntheticLMDataset(cfg.vocab_size, 64, 4, seed=0).batch_at(0).items()}
plain = LM(cfg, impl, device="cuda")
p1 = plain.init(0)
p1, _, m1 = make_train_step(plain, opt)(p1, opt_init(p1), batch)
sharded = LM(cfg, impl, device="cuda", rules=DEFAULT_RULES)
step, _ = shard_train_step(sharded, make_train_step(sharded, opt), mesh)
p2 = sharded.init(0)
p2, _, m2 = step(p2, opt_init(p2), batch)
same = [isinstance(b, DTensor) and torch.equal(a, b.to_local())
        for (_, a), (_, b) in zip(tree_leaves(p1), tree_leaves(p2))]
json.dump({"backend": dist.get_backend(), "loss": [float(m1["loss"]), float(m2["loss"])],
           "gnorm": [float(m1["gnorm"]), float(m2["gnorm"])],
           "same": sum(same), "leaves": len(same)}, open(sys.argv[1], "w"))
dist.destroy_process_group()
'''

_GLOO4 = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.train.compression import pod_allreduce_compressed
torch.cuda.set_device(0)
dist.init_process_group("gloo")
rank, world = dist.get_rank(), dist.get_world_size()
x = np.random.default_rng(5).standard_normal((world, 3, 257)).astype(np.float32)
got = pod_allreduce_compressed({"x": torch.from_numpy(x[rank]).cuda()})["x"]
json.dump({"cuda": got.is_cuda, "x": got.cpu().tolist()},
          open(sys.argv[1] + f"/rank{rank}.json", "w"))
dist.barrier()
dist.destroy_process_group()
'''


_NCCL4 = r'''
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import LM, ModelImpl
from repro_torch.sharding.specs import DEFAULT_RULES
from repro_torch.train import OptConfig, make_train_step, opt_init
from repro_torch.train.compression import pod_allreduce_compressed
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.pipeline import make_pipelined_apply
from repro_torch.train.step import shard_train_step
torch.backends.cuda.matmul.allow_tf32 = False
rank = int(os.environ["RANK"])
torch.cuda.set_device(rank)
dist.init_process_group("nccl")
mesh = make_host_mesh(model=2)
res = {"backend": dist.get_backend()}
impl = ModelImpl(attn="xla", ssd="xla", moe="xla")
opt = OptConfig(lr=1e-3, warmup_steps=1)
for arch in ("granite-moe-1b-a400m", "yi-6b"):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             SyntheticLMDataset(cfg.vocab_size, 64, 4, seed=0).batch_at(0).items()}
    plain = LM(cfg, impl, device="cuda")
    p1 = plain.init(0)
    p1, o1, m1 = make_train_step(plain, opt)(p1, opt_init(p1), batch)
    sharded = LM(cfg, impl, device="cuda", rules=DEFAULT_RULES)
    step, _ = shard_train_step(sharded, make_train_step(sharded, opt), mesh)
    p2 = sharded.init(0)
    p2, o2, m2 = step(p2, opt_init(p2), batch)
    err = max(float((a - b.full_tensor()).abs().max())
              for (_, a), (_, b) in zip(tree_leaves(p1), tree_leaves(p2)))
    # each first moment is (1 - b1) x the clipped gradient: per leaf
    m_err = max(float((a - b.full_tensor()).abs().max()
                      / max(float(a.abs().max()), 1e-30))
                for (_, a), (_, b) in zip(tree_leaves(o1["m"]), tree_leaves(o2["m"])))
    res[arch] = {"loss": [float(m1["loss"]), float(m2["loss"])],
                 "gnorm": [float(m1["gnorm"]), float(m2["gnorm"])], "param_err": err,
                 "moment_err": m_err}
x = np.random.default_rng(5).standard_normal((4, 3, 257)).astype(np.float32)
res["compress"] = pod_allreduce_compressed(
    {"x": torch.from_numpy(x[rank]).cuda()})["x"].cpu().tolist()
S, M = 4, 8
Ws = torch.from_numpy(np.random.default_rng(0).standard_normal((S, 16, 16)).astype(np.float32) * 0.3).cuda()
h = torch.from_numpy(np.random.default_rng(1).standard_normal((M, 2, 4, 16)).astype(np.float32)).cuda()
pipe = make_pipelined_apply(lambda W, v: torch.tanh(v @ W),
                            init_device_mesh("cuda", (S,), mesh_dim_names=("pod",)),
                            axis_name="pod", num_microbatches=M)(Ws, h)
want = h
for s in range(S):
    want = torch.tanh(want @ Ws[s])
res["pipe_err"] = float((pipe - want).abs().max())
json.dump(res, open(sys.argv[1] + f"/rank{rank}.json", "w"))
dist.barrier()
dist.destroy_process_group()
'''


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _ranks(code: str, out: str, world: int, tmp_path, timeout: int = 300):
    path = tmp_path / "rank.py"
    path.write_text(code)
    ranks = run_ranks([sys.executable, str(path), out], world,
                      timeout=timeout, env=dict(os.environ, PYTHONPATH=SRC))
    assert [rc for rc, _ in ranks] == [0] * world


@pytest.mark.gpu
def test_world1_nccl_sharded_step_equals_unsharded(card, tmp_path):
    out = tmp_path / "nccl1.json"
    _ranks(_NCCL1, str(out), 1, tmp_path)
    res = json.loads(out.read_text())
    assert res["backend"] == "nccl"
    assert res["loss"][0] == res["loss"][1]
    assert res["gnorm"][0] == res["gnorm"][1]
    assert res["same"] == res["leaves"] > 0


@pytest.mark.gpu
def test_gloo4_compressed_allreduce_on_cuda_tensors(card, tmp_path):
    _ranks(_GLOO4, str(tmp_path), 4, tmp_path)
    x = np.random.default_rng(5).standard_normal((4, 3, 257)).astype(np.float32)
    want = pod_allreduce_formula(list(x))
    for r in range(4):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["cuda"]
        np.testing.assert_array_equal(np.asarray(got["x"], np.float32), want)


@pytest.fixture
def four_cards(card):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    return card


@pytest.mark.gpu
def test_four_cards_over_nccl(four_cards, tmp_path):
    """A 2x2 mesh of four cards over NCCL: the sharded step against the
    unsharded step on one card (the CPU tests' tolerances: loss 1e-5
    relative, gnorm 1e-4, every leaf's first moment, which is (1 - b1) x
    its clipped gradient, 1e-4 of the leaf's largest, params 2 x lr), the
    compressed all-reduce
    against its formula bit for bit, GPipe over point-to-point between the
    cards within 1e-5 of the sequential stages."""
    _ranks(_NCCL4, str(tmp_path), 4, tmp_path)
    x = np.random.default_rng(5).standard_normal((4, 3, 257)).astype(np.float32)
    want = pod_allreduce_formula(list(x))
    for r in range(4):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["backend"] == "nccl"
        for arch in ("granite-moe-1b-a400m", "yi-6b"):
            (l1, l2), (g1, g2) = got[arch]["loss"], got[arch]["gnorm"]
            assert abs(l2 - l1) <= 1e-5 * abs(l1)
            assert abs(g2 - g1) <= 1e-4 * g1
            print(f"rank {r} {arch}: {got[arch]}")
            assert got[arch]["moment_err"] <= 1e-4, got[arch]["moment_err"]
            assert got[arch]["param_err"] <= 2e-3
        np.testing.assert_array_equal(np.asarray(got["compress"], np.float32),
                                      want)
        assert got["pipe_err"] <= 1e-5

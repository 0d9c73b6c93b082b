"""The dry run's two repairs, on the CPU, against the JAX package's
analytic cost.

- A Shard(i) -> Shard(j) redistribution inside the dry run's traced
  window (``dryrun.card_alltoall``) is issued and counted as the card
  issues it: one all-to-all at the output's local bytes, no all-gather
  (torch's ``cpu`` mesh would gather the whole dim, then chunk it).
  Outside the window torch's own function is back.
- Every cell traces on a mesh: the plain SSD core and the decode
  attention core run per shard (``sharding.specs.per_shard``), and a
  decode step writes the new token's key and value into the shard that
  holds its slot.  ``stablelm-1.6b`` x ``decode_32k`` on the fake 16x16
  mesh (its KV heads split over the model axis), and a train and a
  prefill step of the ``mamba2-780m`` and ``jamba-v0.1-52b`` smoke
  configs on a fake 2x2 mesh (at a cut length and batch), trace, with the
  reference's analytic FLOPs and bytes and its per-device parameter
  bytes; whisper's decode moves no full-length cache.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.launch.roofline as TR
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch.roofline import analytic_cost as janalytic
from repro.models.lm import LM as JLM
from repro.sharding.specs import sanitize_tree as jsanitize_tree
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh


@pytest.fixture
def fake_world():
    """``init(n)`` makes a fake default group of n ranks; destroyed after."""
    yield dryrun.init_fake_world
    if dist.is_initialized():
        dist.destroy_process_group()


def _redistributed(mesh, src, dst, window: bool):
    """The counter's record of one 64 x 64 f32 redistribution."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    with FakeTensorMode():
        d = distribute_tensor(torch.empty(64, 64), mesh, src)
        c = TR.CollectiveCounter()
        with c:
            if window:
                with dryrun.card_alltoall():
                    e = d.redistribute(mesh, dst)
            else:
                e = d.redistribute(mesh, dst)
        return c, tuple(e.to_local().shape)


@pytest.mark.parametrize("shape", [(4,), (2, 2)])
def test_shard_to_shard_is_one_all_to_all(fake_world, shape):
    """Shard(0) -> Shard(1) of a 64 x 64 f32 on the mesh's last axis: one
    all-to-all of the local output's bytes (a 16 x 64 shard in, 64 x 16
    out over 4, 32 x 32 on 2x2: 4,096 B either way), no all-gather, by
    kind, count and op.  Outside the window the same step is torch's ``cpu`` fallback (an
    all-gather of 4 x the bytes over 4 ranks), so the window restored it."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard
    fake_world(4)
    names = ("data", "model")[-len(shape):]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    src = [Shard(0)] * len(shape)
    dst = src[:-1] + [Shard(1)]
    c, local = _redistributed(mesh, src, dst, window=True)
    got = c.record()
    assert local == ((64, 16) if shape == (4,) else (32, 32))
    assert got["all-to-all"] == 4096 and got["_counts"]["all-to-all"] == 1
    assert got["all-gather"] == 0 and got["_counts"]["all-gather"] == 0
    assert sum(v for k, v in got.items() if k != "_counts") == 4096
    assert c.bytes_by_op == {"all-to-all: shard_dim_alltoall(16x64)": 4096}
    c, local2 = _redistributed(mesh, src, dst, window=False)
    assert local2 == local
    assert c.record()["all-to-all"] == 0
    assert c.record()["all-gather"] == 4096 * shape[-1]


def test_card_alltoall_restores_torch():
    from torch.distributed.tensor import _collective_utils, placement_types
    real = _collective_utils.shard_dim_alltoall
    with dryrun.card_alltoall():
        assert placement_types.shard_dim_alltoall is not real
        assert _collective_utils.shard_dim_alltoall is not real
    assert placement_types.shard_dim_alltoall is real
    assert _collective_utils.shard_dim_alltoall is real
    with pytest.raises(ZeroDivisionError):
        with dryrun.card_alltoall():
            1 / 0
    assert placement_types.shard_dim_alltoall is real


def test_whisper_decode_moves_no_full_length_cache(fake_world):
    """``whisper-tiny`` x ``decode_32k`` on the fake 16x16 mesh: its caches
    are split along their length (6 KV heads do not tile the model axis,
    so a rank holds (8, 6, 2,048, 64) of each); the new token is written
    into the shard that holds its slot, so no cache is re-sharded or
    gathered: no collective takes a cache shard, none is an all-to-all,
    and all the step's all-gathers move fewer bytes than the caches a
    chip holds."""
    fake_world(256)
    rec = dryrun.lower_cell("whisper-tiny", "decode_32k",
                            make_production_mesh(device_type="cpu"))
    cfg = get_config("whisper-tiny")
    shard = 128 * cfg.num_kv_heads * 32768 * cfg.head_dim_ * 2 // 256
    assert rec["memory"]["cache_bytes"] >= 2 * cfg.num_layers * shard
    assert rec["collective_counts"]["all-to-all"] == 0
    for op in rec["collective_by_op"]:
        assert "8x6x2048x64" not in op, op
    assert rec["collective_bytes"]["all-gather"] < rec["memory"]["cache_bytes"]


def _param_bytes(jcfg, mesh_shape):
    """Bytes of one device's parameter shards under the reference's
    sanitized specs on a mesh of that shape."""
    names = ("pod", "data", "model")[-len(mesh_shape):]

    class FakeMesh:
        axis_names = names
        devices = np.empty(mesh_shape)
    size = dict(zip(names, mesh_shape))
    ref = JLM(jcfg)
    specs = jsanitize_tree(ref.param_specs(mesh=FakeMesh), ref.abstract_params(),
                           FakeMesh)
    total = 0
    for s, a in zip(jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec)), jax.tree.leaves(
            ref.abstract_params())):
        n = math.prod(a.shape)
        for e in s:
            for ax in (e if isinstance(e, tuple) else (e,) if e else ()):
                n //= size[ax]
        total += n * a.dtype.itemsize
    return total


def check_against_reference(rec, jcfg, jshape, chips, mesh_shape):
    """The record's analytic terms and parameter bytes are the reference's
    for that config, shape and mesh."""
    assert rec["chips"] == chips and rec["mesh"] == list(mesh_shape)
    assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rec["collective_total"] >= 0 and rec["hlo_flops_per_chip"] > 0
    assert rec["memory"]["param_bytes"] == _param_bytes(jcfg, mesh_shape)
    assert rec["memory"]["bytes_per_device"] > 0
    ana = janalytic(jcfg, jshape, microbatches=rec["microbatches"],
                    remat=True, chips=chips, model=JLM(jcfg))
    for k in ("flops_per_chip", "flops_global", "hbm_bytes_per_chip"):
        assert rec[k] == ana[k], k


def test_stablelm_decode_traces_on_16x16(fake_world):
    """32 KV heads split over the model axis with the query heads that
    read them: the decode core runs per (batch, KV head) shard."""
    fake_world(256)
    rec = dryrun.lower_cell("stablelm-1.6b", "decode_32k",
                            make_production_mesh(device_type="cpu"))
    check_against_reference(rec, jget_config("stablelm-1.6b"),
                            JSHAPES["decode_32k"], 256, (16, 16))
    assert rec["collective_counts"]["all-to-all"] == 0


def smoke_configs(monkeypatch):
    """Point the dry run at the smoke configs."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch, smoke=False: get_config(arch, smoke=True))


# the cells' kinds at a size a test can trace (the full shapes take
# minutes on the CPU): seq a multiple of the smoke configs' SSD chunk (32)
SMALL = {"train_4k": (512, 32, "train"), "prefill_32k": (1024, 8, "prefill")}


@pytest.mark.parametrize("arch,shape", [
    ("mamba2-780m", "train_4k"), ("mamba2-780m", "prefill_32k"),
    ("jamba-v0.1-52b", "train_4k"), ("jamba-v0.1-52b", "prefill_32k"),
])
def test_ssd_cells_trace_on_2x2(fake_world, monkeypatch, arch, shape):
    """The SSD core per (batch, head) shard, whole along seq: the smoke
    configs (8 SSD heads over the model axis of 2, the batch over data)
    at the cells' kinds, with the cells' microbatches."""
    from repro.configs.base import ShapeConfig as JShape
    from repro_torch.configs.base import ShapeConfig
    smoke_configs(monkeypatch)
    monkeypatch.setitem(dryrun.SHAPES, shape, ShapeConfig(shape, *SMALL[shape]))
    fake_world(4)
    mesh = make_host_mesh(model=2, device_type="cpu")
    rec = dryrun.lower_cell(arch, shape, mesh)
    assert get_config(arch, smoke=True).ssm_heads % 2 == 0
    assert rec["microbatches"] == (dryrun.TRAIN_MICROBATCHES[arch]
                                   if shape == "train_4k" else 1)
    check_against_reference(rec, jget_config(arch, smoke=True),
                            JShape(shape, *SMALL[shape]), 4, (2, 2))


def test_microbatches_narrower_than_the_batch_axes(fake_world, monkeypatch):
    """qwen3's ``train_4k`` on the multi-pod mesh splits 256 rows into 16
    microbatches of 16 over 32 batch ways.  The same on a fake (2, 2, 2)
    ("pod", "data", "model") world: 32 rows, 16 microbatches of 2 over 4
    batch ways.  The batch is laid out as the activations are, by the
    microbatch's divisible axes (here "pod"), so every rank's rows split
    into whole microbatches; the record holds the reference's analytic
    cost."""
    from repro.configs.base import ShapeConfig as JShape
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeConfig
    smoke_configs(monkeypatch)
    monkeypatch.setitem(dryrun.SHAPES, "train_4k",
                        ShapeConfig("train_4k", 32, 32, "train"))
    fake_world(8)
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    rec = dryrun.lower_cell("qwen3-moe-235b-a22b", "train_4k", mesh)
    assert rec["microbatches"] == 16
    check_against_reference(rec, jget_config("qwen3-moe-235b-a22b",
                                             smoke=True),
                            JShape("train_4k", 32, 32, "train"), 8, (2, 2, 2))


def test_ssd_core_outside_a_mesh_is_unchanged():
    """Without a mesh ``mamba_forward`` calls ``ssd_chunked`` as before,
    on the same arguments in the same order (xh, dt, A, B, C, the chunk,
    the initial state, the path): the same result, bit for bit."""
    from repro_torch.models import mamba
    cfg = dataclasses.replace(get_config("mamba2-780m", smoke=True),
                              dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    p = {k: torch.randn(s.shape, generator=g) * 0.1
         for k, s in mamba.mamba_schema(cfg).items()}
    x = torch.randn(2, 64, cfg.d_model, generator=g)
    calls = []
    real = mamba.ssd_chunked

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    mamba.ssd_chunked = spy
    try:
        out = mamba.mamba_forward(p, x, cfg, impl="xla")
    finally:
        mamba.ssd_chunked = real
    (a, kw), = calls
    assert not kw and len(a) == 8
    assert a[0].shape == (2, 64, cfg.ssm_heads, cfg.ssm_head_dim)
    assert a[5] == cfg.ssm_chunk and a[6] is None and a[7] == "xla"
    assert out.shape == x.shape and torch.isfinite(out).all()

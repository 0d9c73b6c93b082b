"""The port's dry run (``repro_torch.launch.dryrun``), collective counter
(``launch.roofline.CollectiveCounter``) and cost model
(``core.costmodel``) against the JAX package's, on the CPU.

The dry run traces one step on a ``fake`` process group of 256 or 512
ranks under FakeTensorMode: the four cells of ``tests/test_dryrun.py``
complete with a dominant roofline term, per-device parameter bytes equal
those of the reference's sanitized specs on the same mesh, and the
analytic fields equal the reference's ``analytic_cost`` (the same
formulas).  Each cell owns the process's default group and destroys it.
The fourth cell, the multi-pod one, is ``tests/test_torch_dryrun_multipod.py``
(a file of its own, so that test workers trace the two at once).
"""
import json
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core.costmodel as JC
import repro_torch.core.costmodel as TC
import repro_torch.launch.roofline as TR
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch.roofline import analytic_cost as janalytic
from repro.models.lm import LM as JLM
from repro.sharding.specs import sanitize_tree as jsanitize_tree
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh


class FakeMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


@pytest.fixture
def fake_world():
    """``init(n)`` makes a fake default group of n ranks; destroyed after."""
    def init(n):
        dryrun.init_fake_world(n)
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


def _reference_param_bytes(arch, shape):
    """Bytes of one device's parameter shards under the reference's
    sanitized specs on the production mesh of that shape."""
    names = ("pod", "data", "model")[-len(shape):]
    mesh = FakeMesh(shape, names)
    size = dict(zip(names, shape))
    ref = JLM(jget_config(arch))
    specs = jsanitize_tree(ref.param_specs(mesh=mesh), ref.abstract_params(),
                           mesh)
    import jax
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


def _check(rec, arch, shape_name, chips, mesh_shape):
    assert rec["chips"] == chips and rec["mesh"] == list(mesh_shape)
    assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rec["collective_total"] >= 0 and rec["hlo_flops_per_chip"] > 0
    assert rec["memory"]["param_bytes"] == _reference_param_bytes(
        arch, mesh_shape)
    assert rec["memory"]["bytes_per_device"] > 0
    cfg = jget_config(arch)
    ana = janalytic(cfg, JSHAPES[shape_name], microbatches=rec["microbatches"],
                    remat=True, chips=chips, model=JLM(cfg))
    for k in ("flops_per_chip", "flops_global", "hbm_bytes_per_chip"):
        assert rec[k] == ana[k], k


@pytest.mark.parametrize("arch,shape", [
    ("stablelm-1.6b", "train_4k"),
    ("whisper-tiny", "decode_32k"),
])
def test_lower_cell_singlepod(fake_world, arch, shape):
    fake_world(256)
    rec = dryrun.lower_cell(arch, shape, make_production_mesh(
        device_type="cpu"))
    _check(rec, arch, shape, 256, (16, 16))


def test_cli_writes_the_record(tmp_path):
    """``mamba2-780m`` x ``long_500k`` through the CLI (its own group)."""
    dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    assert not dist.is_initialized()
    rec = json.load(open(tmp_path / "singlepod" /
                         "mamba2-780m__long_500k.json"))
    _check(rec, "mamba2-780m", "long_500k", 256, (16, 16))
    assert rec["memory"]["cache_bytes"] > 0


def test_mesh_factories_check_the_world(fake_world):
    fake_world(8)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh(device_type="cpu")
    mesh = make_host_mesh(model=2, device_type="cpu")
    assert tuple(mesh.shape) == (4, 2)
    assert mesh.mesh_dim_names == ("data", "model")


# ---------------------------------------------------- collective counter ---


def test_collective_counter_units(fake_world):
    """The counterpart of ``test_collective_parser_units``: an all-gather
    counted once at its output's bytes, an all-reduce issued in a loop of 8
    counted 8 times; DTensor redistributions and c10d calls alike."""
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    fake_world(4)
    group = dist.group.WORLD
    mesh = make_host_mesh(model=1, device_type="cpu")
    unit = 128 * 256 * 4
    with FakeTensorMode():
        x = torch.empty(32, 256)
        c = TR.CollectiveCounter()
        with c:
            g = funcol.all_gather_tensor(x, 0, group)
            for _ in range(8):
                y = funcol.all_reduce(torch.empty(128, 256), "sum", group)
        assert tuple(g.shape) == (128, 256) and tuple(y.shape) == (128, 256)
        got = c.record()
        assert got["all-gather"] == unit
        assert got["all-reduce"] == unit * 8
        assert got["_counts"]["all-reduce"] == 8
        assert got["_counts"]["all-gather"] == 1
        assert got["reduce-scatter"] == got["all-to-all"] == 0

        d = distribute_tensor(torch.empty(128, 256), mesh,
                              [Shard(0), Replicate()])
        c2 = TR.CollectiveCounter()
        with c2:
            d.redistribute(mesh, [Replicate(), Replicate()])
            dist.all_reduce(torch.empty(64, 256))
        got = c2.record()
        assert got["all-gather"] == unit and got["_counts"]["all-gather"] == 1
        assert got["all-reduce"] == unit // 2
        assert c2.flops == 0


def test_counter_counts_local_flops_and_peak(fake_world):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    fake_world(4)
    mesh = make_host_mesh(model=2, device_type="cpu")
    with FakeTensorMode():
        a = distribute_tensor(torch.empty(64, 32), mesh, [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(32, 16), mesh, [Replicate(), Shard(1)])
        c = TR.CollectiveCounter()
        with c:
            y = a @ w
        assert tuple(y.to_local().shape) == (32, 8)
        assert c.flops == 2 * 32 * 32 * 8          # the local product only
        assert c.peak_bytes == 32 * 8 * 4
        assert c.record()["_counts"] == {k: 0 for k in TR._COLLECTIVES}


def test_counter_counts_a_sharded_layer_exactly(fake_world):
    """One dense layer of the yi smoke config (attention and gated MLP,
    d 64, 4 heads, 2 KV heads, head_dim 16, ffn 128) on DTensors over a
    2x2 ("data", "model") mesh, batch 8 x seq 64, no remat.  Each rank
    holds 4 rows, 2 heads, 1 KV head and half the ffn, so its forward does
    exactly these products (FLOPs = 2 x the multiply-adds):
    q 2*256*64*32, k and v 2*256*64*16 each, scores and values
    2*4*2*64*64*16 each (the plain path's full L x L), out 2*256*32*64,
    MLP 3 x 2*256*64*64.  The backward of a product is two products of
    the same size, so forward + backward is exactly 3 x the forward: a
    backward that gathered a sharded weight and repeated the whole product
    on every rank would count more."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM, ModelImpl
    from repro_torch.sharding.specs import (DEFAULT_RULES, logical_spec,
                                            placements)
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.step import sharded_specs
    fake_world(4)
    mesh = make_host_mesh(model=2, device_type="cpu")
    cfg = get_config("yi-6b", smoke=True)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
            cfg.d_ff) == (64, 4, 2, 16, 128)
    model = LM(cfg, ModelImpl(attn="xla", ssd="xla", moe="xla", remat=False),
               device="cpu", rules=DEFAULT_RULES)
    pspecs, _ = sharded_specs(model, mesh)
    T = 4 * 64                                   # rows x seq on a rank
    want = (2 * T * 64 * 32 + 2 * (2 * T * 64 * 16) + 2 * (2 * 4 * 2 * 64 * 64 * 16)
            + 2 * T * 32 * 64 + 3 * (2 * T * 64 * 64))
    with FakeTensorMode():
        p = dryrun._place(model.abstract_params(), pspecs, mesh)["blocks"][0]
        leaves = [t.requires_grad_(True) for _, t in tree_leaves(p)]
        h = distribute_tensor(
            torch.empty(8, 64, cfg.d_model, dtype=cfg.dtype), mesh,
            placements(logical_spec(("batch", "seq", "embed_act"), None,
                                    mesh), mesh)).requires_grad_(True)
        c = TR.CollectiveCounter()
        with c, implicit_replication():
            out, _ = model.blocks[0].full(p, h)
            fwd = c.flops
            torch.autograd.grad(out.float().square().sum(), leaves + [h])
    assert fwd == want, (fwd, want, c.flops_by_op)
    assert c.flops == 3 * want, (c.flops, c.flops_by_op)
    assert sum(c.flops_by_op.values()) == c.flops
    assert sum(c.bytes_by_op.values()) == sum(
        v for k, v in c.record().items() if k != "_counts")


def test_counter_refuses_a_torch_without_its_propagation_hook(monkeypatch):
    """The counter tells DTensor's sharding propagation from the step's
    work by the propagator's method names; where they are gone it raises
    instead of counting the propagation as work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    for name in [n for n in vars(ShardingPropagator)
                 if n.startswith(TR._PROPAGATE)]:
        monkeypatch.delattr(ShardingPropagator, name)
    with pytest.raises(RuntimeError, match="cannot tell"):
        TR.CollectiveCounter()


def test_roofline_terms_at_h100_rates():
    t = TR.roofline_terms(989e12, 3.35e12, 450e9)     # exactly 1s each
    assert abs(t["compute_s"] - 1) < 1e-9
    assert abs(t["memory_s"] - 1) < 1e-9
    assert abs(t["collective_s"] - 1) < 1e-9
    assert t["roofline_fraction"] == 1.0


# ------------------------------------------------------------ cost model ---

_FIELDS = ("job_id", "user", "submit_time", "runtime", "est_runtime",
           "num_gpus", "gpu_type", "arch")


def _jobs(jobs):
    return [tuple(getattr(j, f) for f in _FIELDS) for j in jobs]


def test_sku_table_is_relative_to_the_h100():
    assert TC.SKU_SPEED["H100"] == 1.0
    for sku, ref in JC.SKU_SPEED.items():
        assert TC.SKU_SPEED[sku] == ref * (197e12 / 989e12)


def test_platform_trace_matches_reference_at_reference_rates(monkeypatch,
                                                             tmp_path):
    monkeypatch.setattr(TC, "_ARTIFACTS", str(tmp_path))
    monkeypatch.setattr(TC, "SKU_SPEED", dict(JC.SKU_SPEED))
    monkeypatch.setattr(TR, "PEAK_FLOPS_BF16", 197e12)
    monkeypatch.setattr(TR, "HBM_BW", 819e9)
    monkeypatch.setattr(TR, "NVLINK_BW", 50e9)
    assert _jobs(TC.generate_platform_trace(64, seed=0)) == \
        _jobs(JC.generate_platform_trace(64, seed=0))


def test_platform_trace_at_h100_rates(monkeypatch, tmp_path):
    monkeypatch.setattr(TC, "_ARTIFACTS", str(tmp_path))
    port = TC.generate_platform_trace(64, seed=1)
    ref = JC.generate_platform_trace(64, seed=1)
    keep = [i for i, f in enumerate(_FIELDS)
            if f not in ("runtime", "est_runtime")]
    assert [[j[i] for i in keep] for j in _jobs(port)] == \
        [[j[i] for i in keep] for j in _jobs(ref)]
    assert any(a.runtime != b.runtime for a, b in zip(port, ref))
    assert all(60.0 <= j.runtime <= 7 * 86400.0 for j in port)


def test_step_time_reads_the_ports_own_artifacts(monkeypatch, tmp_path):
    rec = {"compute_s": 2.0, "memory_s": 1.0, "collective_s": 30.0,
           "chips": 256}
    (tmp_path / "yi-6b__train_4k.json").write_text(json.dumps(rec))
    monkeypatch.setattr(TC, "_ARTIFACTS", str(tmp_path))
    assert TC.step_time("yi-6b", chips=128, sku="H100") == 3.0 * 256 / 128
    assert TC.step_time("yi-6b", chips=256, sku="V100") == \
        3.0 / TC.SKU_SPEED["V100"]

"""The port's distributed pieces on 4 CPU ranks over ``gloo``, against its
single-device pieces and, where the reference still runs here, against the
JAX package.

One 4-rank session (``_SESSION``, launched as 4 processes with a time
limit) computes everything; the tests read its results:

- The sharded train step (``shard_train_step``) of the granite and yi
  smoke configs in f32 on a 2x2 ("data", "model") mesh against the port's
  single-device ``make_train_step``.  The loss within 1e-5 relative and
  each gradient leaf within 1e-4 of its largest entry: the sharded forward
  sums GEMMs and reductions over shards in another order (the losses
  differ by an ulp or so, 4.8e-7 of 6.3), and the smoke models amplify
  f32 rounding in their gradients (one ulp on every weight moves them by
  1.5e-4 of a leaf's largest, ``test_torch_lm_train.py``); measured here
  up to 1.4e-5 (granite).  After the step, every first moment ((1 - b1) x the
  clipped gradient) within 1e-4 of its leaf's largest, and params within
  2 x lr (Adam moves an entry by up to lr where its gradient is within eps
  of zero, whatever its last bits).  The same with two microbatches
  (granite), each the unsharded step's rows.
- ``train_loop`` on the 2x2 mesh shards each parameter as it is drawn: the
  most bytes its init holds at once on a rank stay near its local shards.
- Elastic restore: a checkpoint written from DTensors is byte for byte the
  unsharded save of the same values, the reference's ``load_checkpoint``
  reads it, and restored onto the 2x2 mesh and onto a 4x1 mesh every
  rank's shards equal ``distribute_tensor``'s bit for bit.
- Checkpoint memory: on the 2x2 mesh, no rank but the writer copies more
  than its local shards to the host while it saves, the writer receives
  one shard at a time, and no rank holds more than its local shards and
  its read threads' leaves while it restores.  Uneven and empty shards
  save to the unsharded files and restore to ``distribute_tensor``'s.
- Shard identity: each rank's local shard of a few leaves equals the
  reference's ``NamedSharding`` shard for the device at its mesh position
  (computed with 4 fake JAX devices), on the 2x2 mesh and, for a batch
  split over ("pod", "data"), on a (2, 2, 1) mesh.
- ``pod_allreduce_compressed`` bit for bit against a numpy evaluation of
  its formula, and within the reference test's 0.2 of the mean.
- GPipe (S 4, M 8) within 1e-5 of the reference's ``make_pipelined_apply``
  on 4 fake devices and of the sequential stages.
"""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SRC, run_py
from repro.train.compression import dequantize_int8 as jdequantize
from repro.train.compression import quantize_int8 as jquantize
from repro_torch.launch.ranks import run_ranks as launch
from repro_torch.train.compression import (compress_tree, decompress_tree,
                                           dequantize_int8,
                                           pod_allreduce_formula,
                                           quantize_int8)

WORLD = 4
SESSION_TIMEOUT = 300

_SESSION = r'''
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
out = sys.argv[1]
dist.init_process_group("gloo")
rank = dist.get_rank()
res = {}

from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.lm import LM, ModelImpl
from repro_torch.sharding.specs import DEFAULT_RULES, PS, logical_spec, placements
from repro_torch.train.compression import pod_allreduce_compressed
from repro_torch.train.optimizer import OptConfig, map_tree, opt_init, tree_leaves
from repro_torch.train.pipeline import make_pipelined_apply
from repro_torch.train.step import (distribute_tree, make_train_step,
                                    shard_train_step, sharded_specs)

mesh = make_host_mesh(model=2, device_type="cpu")
impl = ModelImpl(attn="xla", ssd="xla", moe="xla")
opt_cfg = OptConfig(lr=1e-3, warmup_steps=1)

def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t

def moment_err(o1, o2):
    """Each first moment after one step is (1 - b1) x the clipped gradient:
    the largest difference of a leaf over that leaf's largest entry."""
    return max(float((a - full(b)).abs().max() / max(float(a.abs().max()), 1e-30))
               for (_, a), (_, b) in zip(tree_leaves(o1["m"]), tree_leaves(o2["m"])))

for arch in ("granite-moe-1b-a400m", "yi-6b"):
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=torch.float32)
    single = LM(cfg, impl, device="cpu")
    sharded = LM(cfg, impl, device="cpu", rules=DEFAULT_RULES)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLMDataset(cfg.vocab_size, 16, 4, seed=0).batch_at(0).items()}
    # gradients
    p1 = single.init(0)
    leaves = [t.requires_grad_(True) for _, t in tree_leaves(p1)]
    g1 = torch.autograd.grad(single.loss(p1, batch), leaves)
    pspecs, _ = sharded_specs(sharded, mesh)
    dp = distribute_tree(sharded.init(0), pspecs, mesh)
    dleaves = [t.requires_grad_(True) for _, t in tree_leaves(dp)]
    with implicit_replication():
        g2 = torch.autograd.grad(sharded.loss(dp, {k: distribute_tensor(
            v, mesh, placements(logical_spec(("batch", "seq"), None, mesh), mesh))
            for k, v in batch.items()}), dleaves)
    g2 = [full(g.redistribute(t.device_mesh, t.placements)) for g, t in zip(g2, dleaves)]
    grad_err = max(float((a - b).abs().max() / max(float(a.abs().max()), 1e-30))
                   for a, b in zip(g1, g2))
    # one step each
    p1 = single.init(0)
    p1, o1, m1 = make_train_step(single, opt_cfg)(p1, opt_init(p1), batch)
    step, data_pl = shard_train_step(sharded, make_train_step(sharded, opt_cfg), mesh)
    p2 = sharded.init(0)
    p2, o2, m2 = step(p2, opt_init(p2), batch)
    perr = max(float((a - full(b)).abs().max())
               for (_, a), (_, b) in zip(tree_leaves(p1), tree_leaves(p2)))
    res[arch] = {"loss1": float(m1["loss"]), "loss2": float(m2["loss"]),
                 "gnorm1": float(m1["gnorm"]), "gnorm2": float(m2["gnorm"]),
                 "grad_err": grad_err, "param_err": perr,
                 "moment_err": moment_err(o1, o2),
                 "data_placements": [repr(p) for p in data_pl],
                 "all_dtensor": all(isinstance(t, DTensor) for _, t in tree_leaves(p2))}
    if arch == "granite-moe-1b-a400m":
        gran_params = p2
        # two microbatches: each the reference's rows, sharded
        p1 = single.init(0)
        p1, o1, m1 = make_train_step(single, opt_cfg, microbatches=2)(
            p1, opt_init(p1), batch)
        step, _ = shard_train_step(
            sharded, make_train_step(sharded, opt_cfg, microbatches=2), mesh)
        p2 = sharded.init(0)
        p2, o2, m2 = step(p2, opt_init(p2), batch)
        res["mb2"] = {"loss1": float(m1["loss"]), "loss2": float(m2["loss"]),
                      "gnorm1": float(m1["gnorm"]), "gnorm2": float(m2["gnorm"]),
                      "moment_err": moment_err(o1, o2)}

# train_loop on the mesh: its state is sharded as it is drawn, so no rank
# ever holds the full params or moments
from repro_torch.launch.roofline import CollectiveCounter
from repro_torch.launch.train import train_loop
counter = CollectiveCounter()
with counter:
    st = train_loop("granite-moe-1b-a400m", smoke=True, steps=0, device="cpu",
                    mesh=mesh, log_every=0)
state = {"params": st["params"], "opt": st["opt_state"]}
gran_full = LM(get_config("granite-moe-1b-a400m", smoke=True), impl,
               device="cpu").abstract_params()
res["init_mem"] = {
    "peak": counter.peak_bytes,
    "local": sum(t.to_local().numel() * t.element_size()
                 for _, t in tree_leaves(state)),
    "full": sum(t.numel() * (t.element_size() + 8) for _, t in tree_leaves(gran_full)),
    "largest_f32": max(t.numel() * 4 for _, t in tree_leaves(gran_full)),
    "init_equal": all(torch.equal(full(a), b) for (_, a), (_, b) in zip(
        tree_leaves(st["params"]), tree_leaves(LM(get_config(
            "granite-moe-1b-a400m", smoke=True), impl, device="cpu").init(0))))}

# elastic restore
ck = os.path.join(out, "ckpt")
save_checkpoint(os.path.join(ck, "sharded"), 1, {"params": gran_params})
save_checkpoint(os.path.join(ck, "plain"), 1,
                {"params": map_tree(full, gran_params)})
gran = LM(dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True),
                              dtype=torch.float32), impl, device="cpu",
          rules=DEFAULT_RULES)
exact = []
for m in (mesh, make_host_mesh(model=1, device_type="cpu")):
    specs, _ = sharded_specs(gran, m)
    got, at = load_checkpoint(os.path.join(ck, "sharded"), {"params": gran_params},
                              mesh=m, spec_tree={"params": specs})
    want = distribute_tree(map_tree(full, gran_params), specs, m)
    for (_, a), (_, want) in zip(tree_leaves(got["params"]), tree_leaves(want)):
        exact.append(isinstance(a, DTensor) and list(a.placements) == list(want.placements)
                     and torch.equal(a.to_local(), want.to_local()))
res["restore_exact"] = all(exact)
res["restore_leaves"] = len(exact)

# checkpoint memory on the mesh: the host bytes each rank allocates while
# it saves and restores train_loop's sharded state (numpy and Python
# allocations from every thread by tracemalloc, torch storages on this
# thread by the counter)
import tracemalloc
from repro_torch.ckpt import checkpoint as ckpt_mod
ckpt_mod._WORKERS = 1      # one read thread, whatever the host's cores

def host_peak(fn):
    """(fn(), the most bytes numpy and Python held at once, the most that
    torch storages made in the call held at once: what a card would hold)."""
    tracemalloc.start()
    counter = CollectiveCounter()
    with counter:
        out = fn()
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    return out, peak, counter.peak_bytes

gran_specs = sharded_specs(LM(get_config("granite-moe-1b-a400m", smoke=True),
                              impl, device="cpu", rules=DEFAULT_RULES), mesh)
ck_state = os.path.join(ck, "state")
_, save_host, save_dev = host_peak(lambda: save_checkpoint(ck_state, 1, state))
(got, _), restore_host, restore_dev = host_peak(lambda: load_checkpoint(
    ck_state, state, mesh=mesh,
    spec_tree={"params": gran_specs[0], "opt": gran_specs[1]}))
local_bytes = [t.to_local().numel() * t.element_size()
               if isinstance(t, DTensor) else t.numel() * t.element_size()
               for _, t in tree_leaves(state)]
res["ckpt_mem"] = {
    "save_peak": save_host + save_dev, "save_dev": save_dev,
    "restore_peak": restore_host + restore_dev,
    "local": sum(local_bytes), "largest_local": max(local_bytes),
    "table_m": [repr(p) for p in state["opt"]["m"]["embed"]["table"].placements],
    "full": sum(t.numel() * t.element_size() for _, t in tree_leaves(state)),
    "largest": max(t.numel() * t.element_size() for _, t in tree_leaves(state)),
    "leaves": sum(1 for _ in tree_leaves(state)),
    "workers": ckpt_mod._WORKERS, "chunk": ckpt_mod._CHUNK,
    "equal": all(torch.equal(full(a), full(b)) for (_, a), (_, b) in zip(
        tree_leaves(got), tree_leaves(state)))}

# uneven shards: 6 rows over all 4 ranks, a dim shorter than its mesh
# axis, both dims sharded, a leaf replicated over "data", and bf16; saved
# from DTensors on the 2x2 mesh and unsharded, and restored onto the 2x2
# and 4x1 meshes
rng = np.random.default_rng(11)
uneven = {"rows6": (rng.standard_normal((6, 8)), PS(("data", "model"))),
          "short": (rng.standard_normal((1, 5)), PS("data")),
          "both": (rng.standard_normal((7, 3)), PS("data", "model")),
          "rep": (rng.standard_normal((10, 5)), PS(None, "model")),
          "bf16": (rng.standard_normal((5, 3)), PS("model", "data"))}
uneven_full = {k: torch.from_numpy(a.astype(np.float32)).to(
    torch.bfloat16 if k == "bf16" else torch.float32)
    for k, (a, _) in uneven.items()}
uneven_specs = {k: spec for k, (_, spec) in uneven.items()}
uneven_dt = {k: distribute_tensor(v, mesh, placements(uneven_specs[k], mesh))
             for k, v in uneven_full.items()}
_, _, uneven_save_dev = host_peak(lambda: save_checkpoint(
    os.path.join(ck, "uneven_sharded"), 1, uneven_dt))
save_checkpoint(os.path.join(ck, "uneven_plain"), 1, uneven_full)
res["uneven"] = {"save_dev": uneven_save_dev,
                 "largest_local": max(t.to_local().numel() * t.element_size()
                                      for t in uneven_dt.values()),
                 "local_shapes": {k: list(t.to_local().shape)
                                  for k, t in uneven_dt.items()}}
for tag, m in (("2x2", mesh), ("4x1", make_host_mesh(model=1, device_type="cpu"))):
    got, _ = load_checkpoint(os.path.join(ck, "uneven_sharded"), uneven_full,
                             mesh=m, spec_tree=uneven_specs)
    res["uneven"][tag] = {
        k: [repr(p) for p in got[k].placements] + [list(got[k].to_local().shape)]
        + [bool(got[k].dtype == v.dtype and list(got[k].shape) == list(v.shape)
                and torch.equal(got[k].to_local(), distribute_tensor(
                    v, m, placements(uneven_specs[k], m)).to_local())
                and torch.equal(got[k].full_tensor(), v))]
        for k, v in uneven_full.items()}

# shard identity: 2x2 (data, model) and (2, 2, 1) (pod, data, model)
rng = np.random.default_rng(7)
arrays = {"table": rng.standard_normal((64, 8)).astype(np.float32),
          "wq": rng.standard_normal((8, 4, 6)).astype(np.float32),
          "w_gate": rng.standard_normal((4, 8, 6)).astype(np.float32),
          "tokens": rng.integers(0, 99, (8, 6)).astype(np.int32)}
cases = {"table": ("vocab", "embed_table"), "wq": ("embed", "heads", "head_dim"),
         "w_gate": ("experts", "embed", "ffn"), "tokens": ("batch", "seq")}
mesh3 = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
for tag, m in (("2d", mesh), ("3d", mesh3)):
    for name, lg in cases.items():
        spec = logical_spec(lg, None, m)
        t = distribute_tensor(torch.from_numpy(arrays[name]), m, placements(spec, m))
        np.save(os.path.join(out, f"shard_{tag}_{name}_{rank}.npy"), t.to_local().numpy())
np.savez(os.path.join(out, "arrays.npz"), **arrays)

# compressed all-reduce
x = torch.arange(WORLD * 8, dtype=torch.float32).reshape(WORLD, 8)
g = torch.from_numpy(np.random.default_rng(3).standard_normal((WORLD, 5, 7)).astype(np.float32))
red = pod_allreduce_compressed({"g": x[rank], "h": [g[rank]]})
res["compress"] = {"g": red["g"].tolist(), "h": red["h"][0].tolist()}

# GPipe: S 4, M 8, mb 2, L 4, d 16
S, M, mb, L, d = 4, 8, 2, 4, 16
mesh1 = init_device_mesh("cpu", (S,), mesh_dim_names=("pod",))
Ws = torch.from_numpy(np.random.default_rng(0).standard_normal((S, d, d)).astype(np.float32) * 0.3)
h = torch.from_numpy(np.random.default_rng(1).standard_normal((M, mb, L, d)).astype(np.float32))
apply = make_pipelined_apply(lambda W, x: torch.tanh(x @ W), mesh1,
                             axis_name="pod", num_microbatches=M)
res["pipeline"] = apply(Ws, h).numpy().tolist()

with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
dist.barrier()
dist.destroy_process_group()
'''.replace("WORLD", str(WORLD))


def run_ranks(script: str, out_dir: str, world: int = WORLD,
              timeout: int = SESSION_TIMEOUT) -> None:
    """``script`` in ``world`` gloo processes on localhost, ``out_dir`` as
    its argument; all must exit 0 in time."""
    path = os.path.join(out_dir, "session.py")
    with open(path, "w") as f:
        f.write(script)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    ranks = launch([sys.executable, path, out_dir], world, timeout=timeout,
                   env=env, capture=True)
    for r, (rc, out) in enumerate(ranks):
        assert rc == 0, f"rank {r} exited {rc}:\n{(out or '')[-4000:]}"


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    run_ranks(_SESSION, str(out))
    res = [json.load(open(out / f"rank{r}.json")) for r in range(WORLD)]
    return out, res


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "yi-6b"])
def test_sharded_step_matches_single_device(session, arch):
    _, res = session
    for r in res:
        got = r[arch]
        assert got["all_dtensor"]
        assert got["data_placements"] == ["Shard(dim=0)", "Replicate()"]
        assert abs(got["loss2"] - got["loss1"]) <= 1e-5 * abs(got["loss1"])
        assert abs(got["gnorm2"] - got["gnorm1"]) <= 1e-4 * got["gnorm1"]
        assert got["grad_err"] <= 1e-4, got["grad_err"]
        assert got["moment_err"] <= 1e-4, got["moment_err"]
        assert got["param_err"] <= 2 * 1e-3, got["param_err"]
    # every rank reports the same loss
    assert len({r[arch]["loss2"] for r in res}) == 1


def test_sharded_microbatches_are_the_reference_rows(session):
    """Two microbatches on the 2x2 mesh: microbatch i is rows i*B/2 to
    (i+1)*B/2 of the batch, as in the unsharded step, so the losses (the
    MoE aux loss and capacity drops are per microbatch) and every leaf's
    first moment agree within the one-microbatch tolerances."""
    _, res = session
    for r in res:
        got = r["mb2"]
        assert abs(got["loss2"] - got["loss1"]) <= 1e-5 * abs(got["loss1"])
        assert abs(got["gnorm2"] - got["gnorm1"]) <= 1e-4 * got["gnorm1"]
        assert got["moment_err"] <= 1e-4, got["moment_err"]


def test_train_loop_on_a_mesh_never_holds_the_full_state(session):
    """``train_loop(mesh=...)`` draws each parameter and shards it at once,
    and makes the moments from the shards: the most bytes its init held at
    once on a rank stay within its local shards plus two of the largest
    leaf in f32 (the leaf drawn in f32 and cast), well below the full
    params and moments; and the values are the unsharded init's."""
    _, res = session
    for r in res:
        m = r["init_mem"]
        bound = m["local"] + 2 * m["largest_f32"]
        assert bound < m["full"], m
        assert m["peak"] <= bound, m
        assert m["init_equal"]


def test_checkpoint_on_a_mesh_copies_only_local_shards(session):
    """Saving and restoring ``train_loop``'s sharded params and moments on
    the 2x2 mesh: a rank other than the writer allocates no more host bytes
    than its local shards while it saves (it sends them to rank 0 and keeps
    no copy); the writer's torch storages (its card's, on a card) hold at
    most one shard at a time, the largest being its own, whereas a gather
    from every rank would hold the 4 ranks' shards of the embedding table's
    moments, which are replicated over "data"; and every rank's restore
    stays within its local shards plus what its read thread holds (a full
    leaf, a chunk read from the file and the chunk inflated, twice while
    zlib joins its output) plus 4 KiB a leaf for the Python objects of the
    restored tree, a bound below the full state; the restored values are
    the saved ones."""
    _, res = session
    for rank, r in enumerate(res):
        m = r["ckpt_mem"]
        assert m["equal"]
        assert m["local"] < m["full"], m
        if rank:
            assert m["save_peak"] <= m["local"], m
        else:
            assert m["table_m"] == ["Replicate()", "Shard(dim=0)"], m
            assert WORLD * m["largest_local"] > m["largest"], m
            assert m["save_dev"] <= m["largest_local"], m
        threads = m["workers"] * (m["largest"] + 3 * min(m["chunk"],
                                                         m["largest"]))
        bound = m["local"] + threads + 4096 * m["leaves"]
        assert bound < m["full"], m
        assert m["restore_peak"] <= bound, m


def test_sharded_save_is_the_unsharded_save(session):
    out, _ = session
    a, b = out / "ckpt" / "sharded" / "step_00000001", \
        out / "ckpt" / "plain" / "step_00000001"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.msgpack" in names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def test_uneven_sharded_save_is_the_unsharded_save(session):
    """Leaves whose shards differ in size or are empty (6 rows over all 4
    ranks, 1 row over 2, 7 x 3 over both axes, bf16 5 x 3 sharded
    transposed) and one replicated over "data": saved from the 2x2 mesh,
    the files are those of the unsharded save, and the writer's torch
    storages held at most one shard at a time."""
    out, res = session
    u = res[0]["uneven"]
    assert u["local_shapes"] == {"rows6": [2, 8], "short": [1, 5],
                                 "both": [4, 2], "rep": [10, 3],
                                 "bf16": [3, 2]}
    assert [r["uneven"]["local_shapes"]["short"] for r in res] == \
        [[1, 5], [1, 5], [0, 5], [0, 5]]
    assert u["save_dev"] <= u["largest_local"], u
    a, b = out / "ckpt" / "uneven_sharded" / "step_00000001", \
        out / "ckpt" / "uneven_plain" / "step_00000001"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == 6
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.mark.parametrize("tag", ["2x2", "4x1"])
def test_uneven_restore_is_distribute_tensor(session, tag):
    """The uneven leaves restored onto the 2x2 mesh and onto the 4x1 mesh
    (6 rows over 4 ranks leaves the last one empty): on every rank each
    leaf's placements and local shard are ``distribute_tensor``'s of the
    saved values, bit for bit, and its full tensor is the saved one."""
    _, res = session
    shapes = []
    for r in res:
        got = r["uneven"][tag]
        assert all(v[-1] for v in got.values()), got
        shapes.append(got["rows6"][-2])
    assert shapes == ([[2, 8], [1, 8], [2, 8], [1, 8]] if tag == "2x2"
                      else [[2, 8], [2, 8], [2, 8], [0, 8]])


def test_reference_reads_the_sharded_save(session):
    from repro.ckpt import load_checkpoint as jload
    from repro_torch.ckpt import load_checkpoint
    out, _ = session
    path = str(out / "ckpt" / "sharded")
    mine, _ = load_checkpoint(path, _target(path), device="cpu")

    def to_j(t):
        if isinstance(t, dict):
            return {k: to_j(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_j(v) for v in t]
        return jnp.zeros(t.shape, jnp.float32)

    ref, step = jload(path, to_j(mine))
    assert step == 1

    def same(a, b):
        if isinstance(a, dict):
            return all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return all(same(x, y) for x, y in zip(a, b))
        return np.array_equal(a.numpy(), np.asarray(b))

    assert same(mine, ref)


def _target(path):
    """The granite smoke model's f32 params tree, to restore into."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True),
                              dtype=torch.float32)
    return {"params": LM(cfg, device="cpu").init(0)}


def test_elastic_restore_is_bit_exact(session):
    _, res = session
    for r in res:
        assert r["restore_leaves"] > 0 and r["restore_exact"]


def test_local_shards_match_reference_named_sharding(session):
    out, _ = session
    code = f"""
import numpy as np, jax
from jax.sharding import NamedSharding
from repro.sharding.specs import logical_spec
arrays = dict(np.load({str(out / "arrays.npz")!r}))
cases = {{"table": ("vocab", "embed_table"), "wq": ("embed", "heads", "head_dim"),
         "w_gate": ("experts", "embed", "ffn"), "tokens": ("batch", "seq")}}
devs = jax.devices()
for tag, shape, names in (("2d", (2, 2), ("data", "model")),
                          ("3d", (2, 2, 1), ("pod", "data", "model"))):
    mesh = jax.sharding.Mesh(np.array(devs).reshape(shape), names)
    for name, lg in cases.items():
        arr = jax.device_put(arrays[name], NamedSharding(mesh, logical_spec(lg, None, mesh)))
        for sh in arr.addressable_shards:
            np.save({str(out)!r} + f"/ref_{{tag}}_{{name}}_{{sh.device.id}}.npy",
                    np.asarray(sh.data))
print("shards-ok")
"""
    assert "shards-ok" in run_py(code, devices=WORLD)
    for tag in ("2d", "3d"):
        for name in ("table", "wq", "w_gate", "tokens"):
            for r in range(WORLD):
                # device r sits at mesh position r (row-major), as rank r does
                got = np.load(out / f"shard_{tag}_{name}_{r}.npy")
                want = np.load(out / f"ref_{tag}_{name}_{r}.npy")
                np.testing.assert_array_equal(got, want, err_msg=(tag, name, r))


def test_compressed_allreduce_matches_formula(session):
    _, res = session
    x = np.arange(WORLD * 8, dtype=np.float32).reshape(WORLD, 8)
    g = np.random.default_rng(3).standard_normal((WORLD, 5, 7)).astype(
        np.float32)
    for r in res:
        got_g = np.asarray(r["compress"]["g"], np.float32)
        got_h = np.asarray(r["compress"]["h"], np.float32)
        np.testing.assert_array_equal(got_g, pod_allreduce_formula(list(x)))
        np.testing.assert_array_equal(got_h, pod_allreduce_formula(list(g)))
        assert float(np.max(np.abs(got_g - x.mean(axis=0)))) < 0.2


def test_pipeline_matches_reference_and_sequential(session):
    out, res = session
    S, M, mb, L, d = 4, 8, 2, 4, 16
    Ws = np.random.default_rng(0).standard_normal((S, d, d)).astype(
        np.float32) * 0.3
    h = np.random.default_rng(1).standard_normal((M, mb, L, d)).astype(
        np.float32)
    np.save(out / "pipe_W.npy", Ws)
    np.save(out / "pipe_h.npy", h)
    code = f"""
import numpy as np, jax, jax.numpy as jnp
from repro.train.pipeline import make_pipelined_apply
mesh = jax.make_mesh(({S},), ("pod",))
Ws = jnp.asarray(np.load({str(out / "pipe_W.npy")!r}))
h = jnp.asarray(np.load({str(out / "pipe_h.npy")!r}))
apply = make_pipelined_apply(lambda W, x: jnp.tanh(x @ W), mesh,
                             axis_name="pod", num_microbatches={M})
np.save({str(out / "pipe_ref.npy")!r}, np.asarray(apply(Ws, h)))
print("pipe-ok")
"""
    assert "pipe-ok" in run_py(code, devices=WORLD)
    ref = np.load(out / "pipe_ref.npy")
    seq = h
    for s in range(S):
        seq = np.tanh(seq @ Ws[s])
    for r in res:
        got = np.asarray(r["pipeline"], np.float32)
        assert float(np.max(np.abs(got - ref))) < 1e-5
        assert float(np.max(np.abs(got - seq))) < 1e-5


# ------------------------------------------------------- single process ---


def test_quantizers_match_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    for x in (rng.standard_normal((64, 64)) * 3,
              rng.standard_normal((7,)) * 1e-3, np.zeros((5,)),
              np.array([0.5, 1.5, 2.5, -0.5, 127.0, -254.0])):
        x = x.astype(np.float32)
        q, s = quantize_int8(torch.from_numpy(x))
        jq, js = jquantize(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert float(s) == float(js)
        np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                      np.asarray(jdequantize(jq, js)))
        assert float((dequantize_int8(q, s) - torch.from_numpy(x)).abs().max()
                     ) <= float(s) * 0.5 + 1e-6


def test_compress_tree_roundtrip():
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(4, 4, generator=g),
            "b": [torch.randn(3, generator=g).to(torch.bfloat16)]}
    back = decompress_tree(compress_tree(tree))
    for got, want in ((back["a"], tree["a"]), (back["b"][0], tree["b"][0])):
        assert got.dtype == torch.float32
        s = want.float().abs().max() / 127.0
        assert float((got - want.float()).abs().max()) <= float(s) * 0.5 + 1e-6

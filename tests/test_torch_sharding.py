"""The port's sharding specs (``repro_torch.sharding``) against the JAX
package's, and the ``cache_schema`` repair.

Specs are compared entry by entry with the reference's PartitionSpecs: the
cases of ``tests/test_sharding.py``, every rule set, and every leaf of
every config's ``param_specs`` and ``cache_specs`` on the (16, 16) and
(2, 16, 16) production meshes (stand-ins carrying both packages' mesh
attributes, no devices).  The reference stacks layers under a leading
``"layers"`` dim, which no rule shards; the port keeps one entry per layer,
so each of its layer leaves holds the reference's spec without that first
``None``.  No tolerance: specs are exact.
"""
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JPS

import repro.sharding.specs as JS
import repro_torch.sharding.specs as TS
from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import get_config as jget_config
from repro.models.lm import LM as JLM
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.models.lm import LM

PS = TS.PS
RULE_SETS = ("DEFAULT_RULES", "SEQ_PARALLEL_RULES", "NO_FSDP_RULES",
             "TP_ONLY_RULES", "DP_ONLY_RULES")


class FakeMesh:
    """A mesh's names and shape, as both packages read them."""

    def __init__(self, shape, names):
        self.axis_names = self.mesh_dim_names = names
        self.shape = shape
        self.devices = np.empty(shape)


MESH2 = FakeMesh((16, 16), ("data", "model"))
MESH3 = FakeMesh((2, 16, 16), ("pod", "data", "model"))


def _same(port, ref) -> bool:
    return tuple(port) == tuple(ref)


# ------------------------------------------------ tests/test_sharding.py ---


def test_basic_mapping():
    assert TS.logical_spec(("batch", "seq", "embed_act"), mesh=MESH2) == \
        PS("data")
    assert TS.logical_spec(("batch", None, "vocab"), mesh=MESH2) == \
        PS("data", None, "model")


def test_pod_axis_dropped_on_single_pod():
    assert TS.logical_spec(("batch",), mesh=MESH2) == PS("data")
    assert TS.logical_spec(("batch",), mesh=MESH3) == PS(("pod", "data"))


def test_no_duplicate_axis_use():
    spec = TS.logical_spec(("batch", "embed"), mesh=MESH2)
    flat = [a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))]
    assert len(flat) == len(set(flat))


def test_sanitize_drops_indivisible():
    spec = PS("data", "model")
    assert TS.sanitize_spec(spec, (32, 64), MESH2) == PS("data", "model")
    assert TS.sanitize_spec(spec, (32, 6), MESH2) == PS("data")
    assert TS.sanitize_spec(PS(("pod", "data")), (3,), MESH3) == PS()
    assert TS.sanitize_spec(PS(("pod", "data")), (4,), MESH3) == PS("pod")


def test_spec_tree():
    out = TS.spec_tree({"w": ("embed", "ffn"), "b": (None,)}, mesh=MESH2)
    assert out["w"] == PS("data", "model")
    assert out["b"] == PS()


# ------------------------------------------------- against the reference ---

LOGICALS = [("batch", "seq", "embed_act"), ("batch", None, "vocab"),
            ("batch", "embed"), ("embed", "ffn"), ("experts", "embed", "ffn"),
            ("batch", "kv_heads", "kv_seq", "head_dim"), ("batch",),
            ("layers", "embed", "heads", "head_dim"), (None,), (),
            ("batch", "seq", "ssm_inner", None), ("seq", "batch")]


@pytest.mark.parametrize("rules", RULE_SETS)
@pytest.mark.parametrize("mesh", [None, MESH2, MESH3], ids=["none", "2d", "3d"])
def test_logical_spec_matches_reference(rules, mesh):
    assert getattr(TS, rules) == getattr(JS, rules)
    for lg in LOGICALS:
        got = TS.logical_spec(lg, getattr(TS, rules), mesh)
        want = JS.logical_spec(lg, getattr(JS, rules), mesh)
        assert _same(got, want), (lg, got, want)


@pytest.mark.parametrize("mesh", [MESH2, MESH3], ids=["2d", "3d"])
def test_sanitize_spec_matches_reference(mesh):
    specs = [(), ("data",), ("data", "model"), (("pod", "data"),),
             (("pod", "data"), "model"), (None, "model"),
             (("pod", "data", "model"),), ("model", ("pod", "data"))]
    shapes = [(3,), (4,), (32,), (512, 6), (32, 64), (2, 48), (6, 16, 5),
              (1024, 1024)]
    names = set(mesh.mesh_dim_names)
    for sp in specs:
        if any(a not in names for e in sp if e is not None
               for a in (e if isinstance(e, tuple) else (e,))):
            continue
        for shp in shapes:
            got = TS.sanitize_spec(PS(*sp), shp, mesh)
            want = JS.sanitize_spec(JPS(*sp), shp, mesh)
            assert _same(got, want), (sp, shp, got, want)


def test_spec_tree_matches_reference():
    tree = {"w": ("embed", "ffn"), "b": (None,),
            "blocks": [{"wq": ("embed", "heads", "head_dim")}],
            "c": ("batch", "kv_heads", "kv_seq", "head_dim")}
    for mesh in (None, MESH2, MESH3):
        got = TS.spec_tree(tree, mesh=mesh)
        want = JS.spec_tree(tree, mesh=mesh)
        assert _same(got["w"], want["w"]) and _same(got["b"], want["b"])
        assert _same(got["c"], want["c"])
        assert _same(got["blocks"][0]["wq"], want["blocks"][0]["wq"])


def _compare_layered(port, ref, path="") -> int:
    """Walk the port's tree (per-layer lists) beside the reference's
    (layer stacks); every leaf's spec equal.  Returns the leaves seen."""
    if isinstance(port, PS):
        assert isinstance(ref, JPS), path
        assert _same(port, ref), (path, port, ref)
        return 1
    if isinstance(port, list):
        n = 0
        for i, layer in enumerate(port):
            n += _compare_layered(layer, _unstack(ref), f"{path}[{i}]")
        return n
    assert set(port) == set(ref), (path, sorted(port), sorted(ref))
    return sum(_compare_layered(port[k], ref[k], f"{path}.{k}") for k in port)


def _unstack(ref):
    """A layer stack's specs without the leading (unsharded) layer dim."""
    if isinstance(ref, JPS):
        assert len(ref) == 0 or ref[0] is None, ref
        return JPS(*tuple(ref)[1:])
    return {k: _unstack(v) for k, v in ref.items()}


def test_arch_lists_match():
    assert ALL_ARCHS == J_ARCHS


@pytest.mark.parametrize("mesh", [MESH2, MESH3], ids=["2d", "3d"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_cache_specs_match_reference(arch, mesh):
    cfg, jcfg = get_config(arch), jget_config(arch)
    port, ref = LM(cfg, device="meta"), JLM(jcfg)
    n = _compare_layered(port.param_specs(mesh=mesh),
                         ref.param_specs(mesh=mesh))
    assert n > 0
    B, S = 128, 32_768
    ref_cache = ref.cache_specs(B, S, mesh=mesh)
    assert _same(ref_cache.pop("len"), PS())    # a Python int in the port
    assert _compare_layered(port.cache_specs(B, S, mesh=mesh), ref_cache) > 0
    # sanitized against the shapes, leaf for leaf
    ps = TS.sanitize_tree(port.param_specs(mesh=mesh), port.abstract_params(),
                          mesh)
    rs = JS.sanitize_tree(ref.param_specs(mesh=mesh), ref.abstract_params(),
                          mesh)
    _compare_layered(ps, rs)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_schema_kv_axis_matches_reference(arch):
    """The KV-head axis is named only where the heads tile the production
    model axis; otherwise the cache length takes it (the repaired fault)."""
    from repro.models.layers import ParamSpec as JSpec
    from repro_torch.models.layers import ParamSpec
    cfg = get_config(arch)
    port = LM(cfg, device="meta").cache_schema(4, 64)
    ref = JLM(jget_config(arch)).cache_schema(4, 64)

    def walk(p, r):
        if isinstance(p, ParamSpec):
            assert isinstance(r, JSpec)
            assert p.logical == r.logical[1:] and r.logical[0] == "layers"
            assert p.shape == r.shape[1:]
            return
        if isinstance(p, list):
            for layer in p:
                walk(layer, r)
            return
        assert set(p) == set(r)
        for k in p:
            walk(p[k], r[k])

    walk(port["blocks"], ref["blocks"])
    kv = [s for s in _leaves(port) if s.logical[-2:] == ("kv_seq", "head_dim")]
    tiles = cfg.num_kv_heads % TS.PRODUCTION_TP == 0
    assert all(s.logical[1] == ("kv_heads" if tiles else None) for s in kv)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------- placements ---


def test_placements_are_the_inverse_view():
    from torch.distributed.tensor import Replicate, Shard
    assert TS.placements(PS("data", "model"), MESH2) == [Shard(0), Shard(1)]
    assert TS.placements(PS(None, "model"), MESH2) == [Replicate(), Shard(1)]
    assert TS.placements(PS(), MESH3) == [Replicate()] * 3
    assert TS.placements(PS(("pod", "data"), None, "model"), MESH3) == \
        [Shard(0), Shard(0), Shard(2)]
    with pytest.raises(ValueError, match="mesh's axis order"):
        TS.placements(PS(("data", "pod")), MESH3)


def test_constraint_is_identity_on_plain_tensors():
    import torch
    x = torch.arange(6.0).reshape(2, 3)
    assert TS.with_logical_constraint(x, ("batch", "vocab")) is x
    assert TS.splittable(x, 1, 3) is x
    assert TS.gather_fsdp({"w": x})["w"] is x
    assert TS.per_shard(lambda a: a + 1, (x,), (("batch", None),),
                        (("batch", None), x.shape)).equal(x + 1)

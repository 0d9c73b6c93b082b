"""The port's AdamW (``repro_torch.train.optimizer``) against
``repro.train.optimizer`` on the CPU, plus the port analogs of
``tests/test_optimizer.py``.

Tolerances, each with its reason:

- ``schedule``: within 4 ulps of the reference's f32 lr at each step (the
  two libraries' f32 ``cos`` may round apart by one ulp, and ``1 + cos``
  magnifies that near the end of the decay, where it cancels).
- The decay mask: equal leaf by leaf, over every smoke config's tree.
- ``opt_update`` on identical gradients: the step count equal; the global
  norm within 1e-6 relative (a sum of squares in another order), so the
  clip scale too; the moments within 1e-6 of each leaf's largest entry
  (the clip scale's rounding); each f32 entry within 4 ulps of the largest
  of its old and new values plus 1e-5 of the step's lr (Adam moves an
  entry by about lr; the libraries' ``pow``, ``sqrt`` and the clip scale
  round apart by an ulp or so, a moment that nearly cancels magnifies
  that, and where the step cancels most of the value it is many ulps of
  the result), bf16 entries equal but where the f32 result sits at a bf16
  rounding boundary (a fraction of 1e-3, one bf16 ulp apart).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jget_config
from repro.models.lm import LM as JLM
from repro.train import optimizer as J
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.lm import LM
from repro_torch.train import optimizer as T

NORM_RTOL = 1e-6
MOMENT_RTOL = 1e-6
F32_ULPS = 4
STEP_LR_RTOL = 1e-5
BF16_FRACTION = 1e-3


def _params():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(16, 8, generator=g).to(torch.bfloat16),
            "norm": {"scale": torch.ones(8)}}


def test_schedule_warmup_cosine():
    cfg = T.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    assert float(T.schedule(cfg, torch.tensor(0))) == 0.0
    assert abs(float(T.schedule(cfg, torch.tensor(10))) - 1e-3) < 1e-9
    end = float(T.schedule(cfg, torch.tensor(100)))
    assert abs(end - 1e-4) < 1e-6          # decays to min_lr_frac * lr
    mid = float(T.schedule(cfg, torch.tensor(55)))
    assert 1e-4 < mid < 1e-3


@pytest.mark.parametrize("warmup,total", [(10, 100), (5, 12), (5, 8), (0, 1)])
def test_schedule_matches_reference(warmup, total):
    jc = J.OptConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    tc = T.OptConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    for step in range(total + 3):
        want = np.float32(J.schedule(jc, jnp.asarray(step, jnp.int32)))
        got = np.float32(T.schedule(tc, torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 4 * np.spacing(want), (step, got, want)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decay_mask_matches_reference(arch):
    """The reference's mask on its stacked tree, carried to the port's
    per-layer leaves, equals the port's mask on its own keys."""
    jm = JLM(jget_config(arch, smoke=True))
    params = jm.abstract_params()
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    mask_tree = jax.tree_util.tree_unflatten(
        jax.tree.structure(params),
        [np.full(leaf.shape, J._decay_mask(path), np.float32)
         for path, leaf in flat])
    tm = LM(tget_config(arch, smoke=True), device="cpu")
    masks = lm_params_from_jax(mask_tree, _F32Schema(tm))
    n_decay = n_total = 0
    for (path, want), _ in zip(T.tree_leaves(masks),
                               T.tree_leaves(tm.schema())):
        want = set(np.unique(want.numpy()).tolist())
        assert len(want) == 1, path
        assert T.decay_mask(path) == bool(want.pop()), path
        n_decay += T.decay_mask(path)
        n_total += 1
    assert 0 < n_decay < n_total


class _F32Schema:
    """``model``'s schema with every leaf f32, for carrying f32 trees
    (masks, gradients, moments) through ``lm_params_from_jax``'s dtype
    check."""

    def __init__(self, model):
        from repro_torch.models.layers import ParamSpec, map_schema
        self.device = torch.device("cpu")
        self._schema = map_schema(
            lambda s: ParamSpec(s.shape, s.logical, torch.float32, s.init,
                                s.scale), model.schema())

    def schema(self):
        return self._schema


def test_update_moves_params_and_states():
    params = _params()
    w0 = params["w"].clone()
    state = T.opt_init(params)
    grads = {"w": torch.ones(16, 8), "norm": {"scale": torch.ones(8)}}
    cfg = T.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                      weight_decay=0.0)
    p2, s2, stats = T.opt_update(params, grads, state, cfg)
    assert p2 is params and s2 is state          # updated in place
    assert int(s2["step"]) == 1 and s2["step"].dtype == torch.int32
    assert float(stats["gnorm"]) > 0
    assert float((p2["w"].float() - w0.float()).abs().max()) > 0
    # moments are fp32 regardless of param dtype
    assert s2["m"]["w"].dtype == torch.float32
    assert p2["w"].dtype == torch.bfloat16


def test_no_weight_decay_on_norm_scales():
    params = _params()
    w0 = params["w"].clone()
    state = T.opt_init(params)
    zeros = {"w": torch.zeros(16, 8), "norm": {"scale": torch.zeros(8)}}
    cfg = T.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                      weight_decay=0.5)
    p2, _, _ = T.opt_update(params, zeros, state, cfg)
    np.testing.assert_allclose(p2["norm"]["scale"].numpy(), np.ones(8),
                               atol=1e-6)
    assert float(p2["w"].float().abs().max()) < float(w0.float().abs().max())


def test_grad_clip_bounds_update():
    params = _params()
    w0 = params["w"].clone()
    state = T.opt_init(params)
    huge = {"w": torch.full((16, 8), 1e6), "norm": {"scale": torch.full((8,), 1e6)}}
    cfg = T.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10, clip_norm=1.0,
                      weight_decay=0.0)
    T.opt_update(params, huge, state, cfg)
    assert float((params["w"].float() - w0.float()).abs().max()) < 0.3


def _to_jnp(t: torch.Tensor):
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


@pytest.mark.parametrize("clip", [1.0, 1e9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_opt_update_matches_reference(dtype, clip):
    """Three AdamW steps on identical params and gradients (granite smoke's
    tree, random gradients of a few scales), from the same state."""
    cfg = jget_config("granite-moe-1b-a400m", smoke=True)
    tcfg = tget_config("granite-moe-1b-a400m", smoke=True)
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    jm = JLM(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = LM(tcfg, device="cpu")
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tm)
    js = J.opt_init(jp)
    ts = T.opt_init(tp)
    jcfg = J.OptConfig(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=clip)
    tcfg_o = T.OptConfig(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=clip)
    rng = np.random.default_rng(1)
    for it in range(3):
        old = [t.float().clone() for _, t in T.tree_leaves(tp)]
        g_np = jax.tree.map(
            lambda p: (rng.standard_normal(p.shape)
                       * 10.0 ** rng.integers(-4, 1)).astype(np.float32), jp)
        jp, js, jstats = J.opt_update(jp, jax.tree.map(jnp.asarray, g_np), js,
                                      jcfg)
        tg = lm_params_from_jax(g_np, _F32Schema(tm))
        tp, ts, tstats = T.opt_update(tp, tg, ts, tcfg_o)
        assert int(ts["step"]) == int(js["step"]) == it + 1
        assert float(tstats["lr"]) == pytest.approx(float(jstats["lr"]),
                                                    rel=1e-6)
        gn, jgn = float(tstats["gnorm"]), float(jstats["gnorm"])
        assert abs(gn - jgn) <= NORM_RTOL * jgn
        np_tree = jax.tree.map(lambda a: np.asarray(a), js)
        for name in ("m", "v"):
            want = lm_params_from_jax(np_tree[name], _F32Schema(tm))
            for (path, w), (_, g) in zip(T.tree_leaves(want),
                                         T.tree_leaves(ts[name])):
                scale = max(float(w.abs().max()), 1e-30)
                assert float((g - w).abs().max()) <= MOMENT_RTOL * scale, \
                    (it, name, path)
        want_p = lm_params_from_jax(jax.tree.map(np.asarray, jp), tm)
        loose = total = 0
        for (path, w), (_, g), o in zip(T.tree_leaves(want_p),
                                        T.tree_leaves(tp), old):
            w, g = w.float().numpy(), g.float().numpy()
            diff = np.abs(g - w)
            base = np.maximum(np.maximum(np.abs(w), np.abs(g)), np.abs(o.numpy()))
            if tp_dtype(tp, path) == torch.float32:
                allowed = (F32_ULPS * np.spacing(base)
                           + STEP_LR_RTOL * float(jstats["lr"]))
            else:
                allowed = base * 2.0 ** -7          # one bf16 ulp
                loose += int((diff > 0).sum())
                total += diff.size
            assert (diff <= allowed).all(), (it, path, float(diff.max()))
        assert loose <= BF16_FRACTION * max(total, 1), (loose, total)


def tp_dtype(tree, path):
    for key in path:
        tree = tree[key]
    return tree.dtype


def test_opt_update_stats_stay_on_device():
    """The stats are 0-d tensors (a step never reads them on the host)."""
    params = _params()
    _, _, stats = T.opt_update(params, {"w": torch.ones(16, 8),
                                        "norm": {"scale": torch.ones(8)}},
                               T.opt_init(params), T.OptConfig())
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               for v in stats.values())

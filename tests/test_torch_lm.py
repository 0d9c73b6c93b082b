"""The port's LM (prefill + decode) against the JAX package's, on the CPU.

For every registered smoke config, the reference's random parameters are
carried across with ``convert.lm_params_from_jax``; both packages then
prefill the same seeded prompt (and, for vlm/audio, the same patch
embeddings / audio frames) and take three greedy decode steps, each fed the
reference's token.  Compared: the prefill logits, every cache leaf after
prefill, and each decode step's logits and greedy token.

Tolerances: f32 (``dataclasses.replace(cfg, dtype=float32)`` on both sides)
1e-4 of the compared tensor's scale (its largest magnitude, at least 1) —
the same f32 sums in another order; whisper's smoke activations reach ~40,
and its caches then differ by up to ~3e-6 of that scale — and identical
greedy tokens; bf16 at the reference's own prefill/decode tolerances of
``tests/test_models_smoke.py`` (0.15 / 0.2), since the two frameworks round
to bf16 at different places.  The port's kernel path on the CPU (the plain
versions of flash attention, the SSD scan and the router) agrees with its
xla path within 1e-5 in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS, get_config as jget_config
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import build_model
from repro_torch.models.lm import LM, ModelImpl

XLA = ModelImpl(attn="xla", ssd="xla", moe="xla")
STEPS = 3


def _inputs(cfg, B=2, L=24, seed=0):
    """Seeded prompt tokens plus the vlm/audio side inputs, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, L)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "audio":
        out["audio_frames"] = (rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _side(inp: dict, to):
    return {k: to(v) for k, v in inp.items() if k != "tokens"}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _run_jax(cfg, inp, pad_to):
    model = JLM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    side = _side(inp, lambda v: jnp.asarray(v, cfg.dtype))
    logits, cache = model.prefill(params, jnp.asarray(inp["tokens"]),
                                  pad_to=pad_to, **side)
    steps, tok = [], jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    cache0 = cache
    for _ in range(STEPS):
        lg, cache = model.decode_step(params, tok, cache)
        steps.append((np.array(tok), _np(lg)))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)[:, None]
    return params, _np(logits), cache0, steps


def _run_torch(model: LM, params, cfg, inp, pad_to, feed):
    """Prefill, then STEPS decode steps fed the tokens in ``feed``.  Returns
    prefill logits, the cache leaves right after prefill (copied: decode
    writes the KV cache in place), and each step's (argmax, logits)."""
    side = _side(inp, lambda v: torch.from_numpy(v).to(cfg.dtype))
    with torch.inference_mode():
        logits, cache = model.prefill(params, torch.from_numpy(inp["tokens"]),
                                      pad_to=pad_to, **side)
        cache0 = {"len": cache["len"], "blocks": [
            {k: (v.clone() if isinstance(v, torch.Tensor)
                 else {kk: vv.clone() for kk, vv in v.items()})
             for k, v in c.items()} for c in cache["blocks"]]}
        steps = []
        for tok in feed:
            lg, cache = model.decode_step(params, torch.from_numpy(tok), cache)
            steps.append((torch.argmax(lg, dim=-1).numpy(), _np(lg)))
    return _np(logits), cache0, steps


def _close(got, want, tol, msg=""):
    """max |got - want| <= tol * max(1, max |want|)."""
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{msg}: max abs err {err:.3e} > {tol} * {scale:.3g}"


def _cache_pairs(jcache, tcache):
    """(path, reference leaf, port leaf) for every cache leaf: the
    reference's stacks carry a leading layer dim, the port keeps a list."""
    out = []

    def walk(j, t, path):
        if isinstance(t, dict):
            assert set(t) == set(j), (path, sorted(t), sorted(j))
            for k in t:
                walk(j[k], t[k], f"{path}.{k}")
        else:
            out.append((path, j, t))

    for i, entry in enumerate(tcache["blocks"]):
        walk(jax.tree.map(lambda a: a[i], jcache["blocks"]), entry,
             f"blocks[{i}]")
    return out


def _compare(arch, dtype, tol_pre, tol_dec, exact_tokens):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), dtype=dtype[0])
    tcfg = dataclasses.replace(tget_config(arch, smoke=True), dtype=dtype[1])
    inp = _inputs(jcfg)
    pad_to = inp["tokens"].shape[1] + STEPS + 1
    jparams, jlogits, jcache, jsteps = _run_jax(jcfg, inp, pad_to)
    model = build_model(tcfg, device="cpu")
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), model)
    tlogits, tcache, tsteps = _run_torch(model, params, tcfg, inp, pad_to,
                                         [t for t, _ in jsteps])
    V = jcfg.vocab_size
    _close(tlogits[:, :V], jlogits[:, :V], tol_pre, "prefill logits")
    assert tcache["len"] == int(jcache["len"])
    for path, j, t in _cache_pairs(jcache, tcache):
        assert tuple(t.shape) == tuple(j.shape), path
        _close(_np(t), _np(j), tol_pre, path)
    for i, ((jtok, jlg), (ttok, tlg)) in enumerate(zip(jsteps, tsteps)):
        _close(tlg[:, :V], jlg[:, :V], tol_dec, f"decode step {i}")
        if exact_tokens:
            want = np.argmax(jlg, axis=-1)
            np.testing.assert_array_equal(ttok, want, err_msg=f"step {i}")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_lm_matches_reference_f32(arch):
    _compare(arch, (jnp.float32, torch.float32), 1e-4, 1e-4, True)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_lm_matches_reference_bf16(arch):
    _compare(arch, (jnp.bfloat16, torch.bfloat16), 0.15, 0.2, False)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_kernel_path_matches_xla_path_f32(arch):
    """On the CPU the kernel path runs the plain versions of the kernels;
    they must give what the reference's einsum path gives, within 1e-5."""
    cfg = dataclasses.replace(tget_config(arch, smoke=True),
                              dtype=torch.float32)
    inp = _inputs(cfg, seed=1)
    pad_to = inp["tokens"].shape[1] + STEPS + 1
    kern = build_model(cfg, device="cpu")
    xla = build_model(cfg, impl=XLA, device="cpu")
    params = kern.init(seed=3)
    feed = [np.full((2, 1), 7 + i, np.int32) for i in range(STEPS)]
    got = _run_torch(kern, params, cfg, inp, pad_to, feed)
    want = _run_torch(xla, params, cfg, inp, pad_to, feed)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    for (_, g), (_, w) in zip(got[2], want[2]):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def test_forward_and_hidden_states_match_reference():
    """The full-sequence path (``forward`` and the MoE aux loss of
    ``hidden_states``) on the hybrid smoke config, f32."""
    arch = "jamba-v0.1-52b"
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), dtype=jnp.float32)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True),
                               dtype=torch.float32)
    toks = _inputs(jcfg)["tokens"]
    jm = JLM(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    jlog = _np(jm.forward(jparams, jnp.asarray(toks)))
    _, jaux = jm.hidden_states(jparams, jnp.asarray(toks))
    model = build_model(tcfg, device="cpu")
    params = lm_params_from_jax(jax.tree.map(np.asarray, jparams), model)
    with torch.inference_mode():
        tlog = _np(model.forward(params, torch.from_numpy(toks)))
        _, taux = model.hidden_states(params, torch.from_numpy(toks))
    V = jcfg.vocab_size
    np.testing.assert_allclose(tlog[..., :V], jlog[..., :V], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert model.param_count() == jm.param_count()
    assert model.active_param_count() == jm.active_param_count()


def test_router_topk_breaks_ties_to_the_lowest_expert():
    from repro.models.moe import router_topk as jtopk
    from repro_torch.models.moe import router_topk as ttopk
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 3.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.0, -1.0, 5.0, 5.0, -1.0]], np.float32)
    for k in (1, 2, 3, 5):
        jw, ji = jtopk(jnp.asarray(logits), k)
        tw, ti = ttopk(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7)


def test_lm_params_from_jax_rejects_a_mismatched_tree():
    cfg = dataclasses.replace(jget_config("yi-6b", smoke=True),
                              dtype=jnp.float32)
    jparams = jax.tree.map(np.asarray, JLM(cfg).init(jax.random.PRNGKey(0)))
    model = build_model(dataclasses.replace(tget_config("yi-6b", smoke=True),
                                            dtype=torch.float32), device="cpu")
    params = lm_params_from_jax(jparams, model)
    assert len(params["blocks"]) == cfg.num_layers
    bad = dict(jparams, embed={"table": jparams["embed"]["table"][:, :3]})
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_jax(bad, model)
    bf16 = build_model("yi-6b", smoke=True, device="cpu")
    with pytest.raises(TypeError, match="dtype"):
        lm_params_from_jax(jparams, bf16)


@pytest.mark.parametrize("owner", ["LM", "build_model"])
def test_lm_needs_cuda_unless_asked_for_the_cpu(owner, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tget_config("jamba-v0.1-52b", smoke=True)
    make = LM if owner == "LM" else build_model
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(cfg, device="cuda")
    assert make(cfg, device="cpu").device.type == "cpu"

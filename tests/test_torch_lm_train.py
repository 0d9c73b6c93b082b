"""The port's LM training half (``LM.loss`` with remat and chunked
cross-entropy, gradients, ``make_train_step``, ``train_loop`` and its
restart) against the JAX package's, on the CPU.

The reference's random parameters are carried across with
``convert.lm_params_from_jax`` (its layer stacks become the port's
per-layer lists; gradients are compared the same way), and batches come
from the same seeded ``SyntheticLMDataset``.  Where a run starts from the
port's own seeded weights (``train_loop``), those are carried the other way
by ``_to_reference``.

Tolerances, each with its reason:

- ``LM.loss``, f32: within 1e-5 (the losses sit near 6.3, whose f32 ulp is
  4.8e-7; the two frameworks sum logits, norms and GEMMs in other orders,
  and differ by up to 4 ulps over every smoke config).  bf16: within 5e-3
  (the frameworks round activations to bf16 at different places; the
  smoke configs differ by up to 6.9e-4).
- Gradients, f32: each leaf within 2e-4 of its largest reference entry.
  The forward passes differ by f32 rounding, and the smoke models amplify
  it: moving every weight of the port's granite smoke model by one ulp
  moves its own gradients by 1.5e-4 of a leaf's largest entry
  (``test_gradient_tolerance_is_f32_conditioning`` holds that measurement).
- One train step: the loss within 1e-5; the global gradient norm within
  1e-4 relative (it sums the gradients above); after AdamW, every entry
  within ``2 * lr`` of the reference's and all but a fraction of 5e-3
  within 1e-6.  Adam's first step moves an entry by ``lr * g / (|g| +
  eps)``: where a gradient is within a few eps (1e-8) of zero, its last
  bits (or its sign) move that step by up to lr.  6.6e-4 and 7.0e-4 of the
  entries do so here (microbatches 2 and 1), 9.7e-4 on the card against
  the CPU (``chip_smoke.py`` phase 23).
- ``train_loop`` against the reference's own loop, bf16 granite smoke:
  each of 6 losses within 2e-2 (bf16 weights: one ulp is 2^-8 of a
  weight, and two frameworks' bf16 roundings of the same update drift
  apart step by step: 3.4e-3 by step 6 at lr 3e-4, 1.8e-2 at 3e-3).
- Remat ``full`` / ``dots`` / ``none``, chunked and unchunked
  cross-entropy in the port: the same loss and gradients bit for bit
  (recomputation repeats the same CPU ops), resp. within 1e-5 (chunk sums
  in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jget_config
from repro.data import SyntheticLMDataset as JDataset
from repro.models.lm import LM as JLM
from repro.models.lm import ModelImpl as JImpl
from repro.train import OptConfig as JOptConfig
from repro.train import make_train_step as jmake_train_step
from repro.train import opt_init as jopt_init
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import batch_for
from repro_torch.launch import train as train_mod
from repro_torch.models.lm import LM, ModelImpl
from repro_torch.train import OptConfig, make_eval_step, make_train_step, opt_init
from repro_torch.train.optimizer import tree_leaves
from test_torch_optim import _F32Schema

XLA = dict(attn="xla", ssd="xla", moe="xla")
SEQ = 32
LOSS_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
GRAD_RTOL = 2e-4
STEP_ATOL = 1e-6
STEP_FRACTION = 5e-3
LOOP_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU threads contend with JAX's in one process; one thread
    keeps the port's side fast.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch: str, dtype: str):
    jc, tc = jget_config(arch, smoke=True), tget_config(arch, smoke=True)
    if dtype == "float32":
        jc = dataclasses.replace(jc, dtype=jnp.float32)
        tc = dataclasses.replace(tc, dtype=torch.float32)
    return jc, tc


def _setup(arch: str, dtype: str, B: int = 2, seed: int = 0):
    """(reference model, its params, port config, port params, numpy
    batch) for ``arch``'s smoke config."""
    jc, tc = _configs(arch, dtype)
    jm = JLM(jc)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = LM(tc, ModelImpl(**XLA), device="cpu")
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tm)
    L = SEQ + (tc.num_patches if tc.family == "vlm" else 0)
    batch = batch_for(tc, ShapeConfig("train", L, B, "train"), step=seed)
    return jc, jp, tc, tp, batch


def _jbatch(batch, jc) -> dict:
    return {k: jnp.asarray(v, jc.dtype if v.dtype == np.float32 else None)
            for k, v in batch.items()}


def _tbatch(batch, tc) -> dict:
    return {k: (torch.from_numpy(v).to(tc.dtype) if v.dtype == np.float32
                else torch.from_numpy(v)) for k, v in batch.items()}


def _grads(model: LM, params, batch) -> list[torch.Tensor]:
    leaves = [t for _, t in tree_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = model.loss(params, batch)
        return [loss.detach()] + list(torch.autograd.grad(loss, leaves))
    finally:
        for t in leaves:
            t.requires_grad_(False)


def _ref_leaves(tree_np, model: LM) -> list[torch.Tensor]:
    """A reference tree (stacked layers) as the port's leaves, in order."""
    return [t for _, t in tree_leaves(lm_params_from_jax(tree_np, model))]


def _to_reference(params) -> dict:
    """The port's per-layer params as the reference's tree (each list of
    layers stacked on a leading dim), as jnp arrays."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return jax.tree.map(lambda *xs: jnp.stack(xs), *[walk(e) for e in t])
        return jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else t.numpy().dtype)
    return walk(params)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / max(scale, 1e-30)


# ------------------------------------------------------------------- loss ---

@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_matches_reference(arch, dtype, chunk):
    jc, jp, tc, tp, batch = _setup(arch, dtype)
    want = float(JLM(jc, JImpl(loss_chunk=chunk)).loss(jp, _jbatch(batch, jc)))
    tm = LM(tc, ModelImpl(**XLA, loss_chunk=chunk), device="cpu")
    got = float(tm.loss(tp, _tbatch(batch, tc)))
    assert np.isfinite(got)
    assert abs(got - want) <= LOSS_TOL[dtype], (got, want)


# -------------------------------------------------------------- gradients ---

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_grads_match_reference(arch):
    """f32 gradients per leaf against ``jax.grad(model.loss)``, the
    reference's stacked leaves carried to the port's per-layer leaves.

    Every port gradient is finite.  The reference's SSD backward gives
    nan (its ``exp`` of the masked segment sums overflows, and the mask's
    zero cotangent times inf is nan; the port masks before the ``exp``),
    so it is compared on the reference's finite entries, which are whole
    sums untouched by the nan.  Cross-attention key biases have a zero
    gradient in exact arithmetic (a bias shared by every key shifts a
    query's logits alike): there both packages' rounding noise lies below
    1e-5 of the same layer's key-weight gradient."""
    jc, jp, tc, tp, batch = _setup(arch, "float32")
    jm = JLM(jc)
    jg = jax.grad(jm.loss)(jp, _jbatch(batch, jc))
    tm = LM(tc, ModelImpl(**XLA), device="cpu")
    got = _grads(tm, tp, _tbatch(batch, tc))[1:]
    want = _ref_leaves(jax.tree.map(np.asarray, jg), tm)
    assert len(got) == len(want)
    grads = dict(zip([path for path, _ in tree_leaves(tp)], zip(got, want)))
    n_nan = 0
    for path, (g, w) in grads.items():
        assert bool(torch.isfinite(g).all()), path
        fin = torch.isfinite(w)
        n_nan += int((~fin).sum())
        if path[-2:] == ("cross", "bk"):
            scale = float(grads[path[:-1] + ("wk",)][1].abs().max())
            assert float(g.abs().max()) <= 1e-5 * scale, path
            assert float(w.abs().max()) <= 1e-5 * scale, path
        elif bool(fin.any()):
            err = _rel_err(g[fin], w[fin])
            assert err <= GRAD_RTOL, (path, err)
    assert (n_nan > 0) == (tc.family in ("ssm", "hybrid")), n_nan


def test_gradient_tolerance_is_f32_conditioning():
    """GRAD_RTOL's reason: in the port alone, moving every weight of the
    granite smoke model by one f32 ulp (seeded signs) moves its gradients
    by more than a tenth of GRAD_RTOL of some leaf's largest entry, so
    two frameworks' f32 roundings of one forward pass may do the same."""
    _, _, tc, tp, batch = _setup("granite-moe-1b-a400m", "float32")
    tm = LM(tc, ModelImpl(**XLA), device="cpu")
    tb = _tbatch(batch, tc)
    g0 = _grads(tm, tp, tb)[1:]
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for _, t in tree_leaves(tp):
            sign = torch.randint(0, 2, t.shape, generator=gen).float() * 2 - 1
            t.mul_(1 + sign * 2.0 ** -23)
    g1 = _grads(tm, tp, tb)[1:]
    worst = max(_rel_err(a, b) for a, b in zip(g1, g0))
    assert GRAD_RTOL / 10 < worst < GRAD_RTOL, worst


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b",
                                  "whisper-tiny"])
def test_remat_policies_agree(arch, chunk):
    """``full``, ``dots`` and ``none`` rematerialization give the same loss
    and gradients bit for bit; chunked cross-entropy within 1e-5 of the
    unchunked loss (its chunk sums run in another order)."""
    _, _, tc, tp, batch = _setup(arch, "float32")
    tb = _tbatch(batch, tc)
    runs = {}
    for policy in ("full", "dots", "none"):
        tm = LM(tc, ModelImpl(**XLA, remat_policy=policy, loss_chunk=chunk),
                device="cpu")
        runs[policy] = _grads(tm, tp, tb)
    for policy in ("dots", "none"):
        for a, b in zip(runs[policy], runs["full"]):
            assert torch.equal(a, b), policy
    unchunked = LM(tc, ModelImpl(**XLA), device="cpu").loss(tp, tb)
    assert abs(float(runs["full"][0]) - float(unchunked)) <= 1e-5
    # without autograd the wrapped layers run plain
    with torch.no_grad():
        assert torch.equal(make_eval_step(LM(tc, ModelImpl(
            **XLA, loss_chunk=chunk), device="cpu"))(tp, tb), runs["full"][0])


# ------------------------------------------------------------- train step ---

def _assert_step_close(got_params, want_np, old_params, lr: float,
                       model: LM) -> None:
    """Every entry within 2 lr of the reference's, all but a fraction of
    STEP_FRACTION within STEP_ATOL (bf16 leaves: one bf16 ulp of the
    leaf's largest entry)."""
    want = _ref_leaves(want_np, model)
    loose = total = 0
    for (path, g), w in zip(tree_leaves(got_params), want):
        diff = (g.float() - w.float()).abs()
        assert bool((diff <= 2 * lr + 1e-6).all()), path
        tol = STEP_ATOL if g.dtype == torch.float32 else \
            float(w.float().abs().max()) * 2.0 ** -8
        loose += int((diff > tol).sum())
        total += diff.numel()
    assert loose <= STEP_FRACTION * total, (loose, total)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """One ``make_train_step`` step (f32 granite smoke, batch 4) against the
    reference's on the same params and batch."""
    jc, jp, tc, tp, batch = _setup("granite-moe-1b-a400m", "float32", B=4)
    jcfg = JOptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    tcfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jmake_train_step(JLM(jc), jcfg, microbatches=microbatches)
    jp2, js2, jm = jstep(jp, jopt_init(jp), _jbatch(batch, jc))
    tm = LM(tc, ModelImpl(**XLA), device="cpu")
    tstep = make_train_step(tm, tcfg, microbatches=microbatches)
    old = [t.clone() for _, t in tree_leaves(tp)]
    tp2, ts2, mt = tstep(tp, opt_init(tp), _tbatch(batch, tc))
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in mt.values())
    assert abs(float(mt["loss"]) - float(jm["loss"])) <= LOSS_TOL["float32"]
    assert float(mt["gnorm"]) == pytest.approx(float(jm["gnorm"]), rel=1e-4)
    assert float(mt["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(ts2["step"]) == 1
    assert not all(torch.equal(a, b) for a, (_, b) in zip(old, tree_leaves(tp2)))
    assert all(not t.requires_grad for _, t in tree_leaves(tp2))
    _assert_step_close(tp2, jax.tree.map(np.asarray, jp2), old,
                       float(jm["lr"]), tm)
    for name in ("m", "v"):
        want = _ref_leaves(jax.tree.map(np.asarray, js2[name]),
                           _F32Schema(tm))
        for (path, g), w in zip(tree_leaves(ts2[name]), want):
            assert _rel_err(g, w) <= GRAD_RTOL * (2 if name == "v" else 1), \
                (name, path)


def test_microbatches_accumulate_like_one_batch():
    """The port alone: 2 microbatches of 2 give the 4-row batch's loss and
    step (``tests/test_train_serve.py::test_microbatch_equivalence``)."""
    _, _, tc, tp, batch = _setup("stablelm-1.6b", "float32", B=4, seed=1)
    tb = _tbatch(batch, tc)
    cfg = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    tm = LM(tc, ModelImpl(**XLA), device="cpu")
    outs = []
    for k in (1, 2):
        p = _clone(tp)
        outs.append(make_train_step(tm, cfg, microbatches=k)(p, opt_init(p), tb))
    assert abs(float(outs[0][2]["loss"]) - float(outs[1][2]["loss"])) < 5e-2
    worst = max(float((a.float() - b.float()).abs().max())
                for (_, a), (_, b) in zip(tree_leaves(outs[0][0]),
                                          tree_leaves(outs[1][0])))
    assert worst < 0.05


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


# -------------------------------------------------------------- the loop ---

ARCH = "granite-moe-1b-a400m"
LOOP = dict(smoke=True, batch=4, seq=32, log_every=0, device="cpu")


def test_loss_decreases():
    """``tests/test_train_serve.py::test_loss_decreases`` on the port."""
    _, tc = _configs("yi-6b", "bfloat16")
    tm = LM(tc, ModelImpl(**XLA), device="cpu")
    params = tm.init(0)
    opt = opt_init(params)
    step = make_train_step(tm, OptConfig(lr=3e-3, warmup_steps=2,
                                         total_steps=30))
    from repro_torch.data import SyntheticLMDataset
    ds = SyntheticLMDataset(tc.vocab_size, 64, 8, seed=0)
    losses = []
    for i in range(25):
        b = {k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses


def test_train_loop_matches_reference_loop():
    """6 steps of ``train_loop`` (bf16 granite smoke, lr 3e-4) against the
    reference's own loop (``make_train_step`` jitted, the reference's
    ``SyntheticLMDataset(seed=0)``, its ``OptConfig`` rule) from the port's
    seeded initial weights.  The reference's ``train_loop`` itself fails
    on this JAX version (ROADMAP Queue 3), so its loop is rebuilt here."""
    steps, lr = 6, 3e-4
    out = train_mod.train_loop(ARCH, steps=steps, lr=lr, **LOOP)
    jc = jget_config(ARCH, smoke=True)
    tm = LM(tget_config(ARCH, smoke=True), device="cpu")
    jp = _to_reference(tm.init(0))
    jstep = jax.jit(jmake_train_step(JLM(jc, JImpl()), JOptConfig(
        lr=lr, warmup_steps=max(steps // 10, 5), total_steps=steps)))
    jopt = jopt_init(jp)
    ds = JDataset(jc.vocab_size, LOOP["seq"], LOOP["batch"], seed=0)
    want = []
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in ds.batch_at(i).items()}
        jp, jopt, m = jstep(jp, jopt, b)
        want.append(float(m["loss"]))
    assert len(out["losses"]) == steps and out["start_step"] == 0
    assert np.all(np.isfinite(out["losses"])) and np.all(np.isfinite(out["gnorms"]))
    np.testing.assert_allclose(out["losses"], want, rtol=0, atol=LOOP_TOL)
    assert out["losses"][0] == pytest.approx(want[0], abs=LOSS_TOL["bfloat16"])


def test_train_loop_checkpoint_restart(tmp_path):
    """``tests/test_train_serve.py::test_train_loop_with_checkpoint_restart``
    on the port: a 6-step run checkpoints at 3 and 6; ``steps=8`` on the
    same directory resumes at 6 and runs only 2 steps."""
    out1 = train_mod.train_loop(ARCH, steps=6, ckpt_dir=str(tmp_path),
                                ckpt_interval=3, **LOOP)
    out2 = train_mod.train_loop(ARCH, steps=8, ckpt_dir=str(tmp_path),
                                ckpt_interval=3, **LOOP)
    assert len(out1["losses"]) == 6
    assert out2["start_step"] == 6 and len(out2["losses"]) == 2


class _Preempted(Exception):
    pass


def _preempt_at(monkeypatch, at: int) -> None:
    """Make ``train_loop``'s data stream fail when step ``at`` asks for its
    batch, as a job killed there (its checkpoints already written)."""
    real = train_mod.SyntheticLMDataset

    class Preempting(real):
        def batch_at(self, step):
            if step == at:
                raise _Preempted(step)
            return super().batch_at(step)

    monkeypatch.setattr(train_mod, "SyntheticLMDataset", Preempting)


def test_train_loop_resumes_as_if_uninterrupted(tmp_path, monkeypatch):
    """An 8-step run killed after step 6 (checkpoints every 3), then
    restarted: the restart trains steps 7-8 only, with the losses and final
    weights of an uninterrupted 8-step run bit for bit (one CPU thread)."""
    full = train_mod.train_loop(ARCH, steps=8, **LOOP)
    with monkeypatch.context() as m:
        _preempt_at(m, 6)
        with pytest.raises(_Preempted):
            train_mod.train_loop(ARCH, steps=8, ckpt_dir=str(tmp_path),
                                 ckpt_interval=3, **LOOP)
    resumed = train_mod.train_loop(ARCH, steps=8, ckpt_dir=str(tmp_path),
                                   ckpt_interval=3, **LOOP)
    assert resumed["start_step"] == 6
    assert resumed["losses"] == full["losses"][6:]
    for (path, a), (_, b) in zip(tree_leaves(resumed["params"]),
                                 tree_leaves(full["params"])):
        assert torch.equal(a, b), path
    for name in ("m", "v", "step"):
        for (path, a), (_, b) in zip(tree_leaves(resumed["opt_state"][name]),
                                     tree_leaves(full["opt_state"][name])):
            assert torch.equal(a, b), (name, path)


def test_train_cli(capsys, tmp_path, monkeypatch):
    """``python -m repro_torch.launch.train`` on the CPU: trains, then
    resumes from its checkpoint; it defaults to CUDA (raising without it);
    ``--production-mesh`` / ``--multi-pod`` join the job's process group
    (here a world of one rank over gloo) and raise where it is smaller than
    the mesh, leaving no group behind."""
    argv = ["--arch", ARCH, "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-interval", "2"]
    train_mod.main(argv)
    assert "final loss" in capsys.readouterr().out
    train_mod.main(argv[:4] + ["6"] + argv[5:])
    assert "restored checkpoint at step 4" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_mod.main(["--arch", ARCH, "--smoke", "--steps", "1"])
    import socket

    import torch.distributed as dist
    for flag, ranks in (("--production-mesh", 256), ("--multi-pod", 512)):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"),
                     ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port))):
            monkeypatch.setenv(k, v)
        with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
            train_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu", flag])
        assert not dist.is_initialized()


# --------------------------------------------------------------- roofline ---

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_analytic_cost_matches_reference(arch):
    """``launch.roofline``'s analytic model equals the reference's formulas
    (full configs, every shape, 256 chips and 1), and ``roofline_terms``
    divides by the H100's rates."""
    from repro.configs.base import SHAPES as JSHAPES
    from repro.launch import roofline as JR
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import roofline as TR
    jc, tc = jget_config(arch), tget_config(arch)
    jm, tm = JLM(jc), LM(tc, device="cpu")
    for shape in JSHAPES:
        for chips, mb in ((256, 1), (1, 4)):
            want = JR.analytic_cost(jc, shape, microbatches=mb, chips=chips,
                                    model=jm)
            got = TR.analytic_cost(tc, shape, microbatches=mb, chips=chips,
                                   model=tm)
            assert got == want, (shape, chips)
        assert TR.model_flops(tc, shape, tm.active_param_count()) == \
            JR.model_flops(jc, shape, jm.active_param_count())
    terms = TR.roofline_terms(2e15, 6.7e12, 9e11)
    assert terms["compute_s"] == 2e15 / tmesh.PEAK_FLOPS_BF16
    assert terms["memory_s"] == 6.7e12 / tmesh.HBM_BW
    assert terms["collective_s"] == 9e11 / tmesh.NVLINK_BW
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)
    assert terms["dominant"] == "compute_s"

"""The port's LM training on the card against the same on the CPU, and its
checkpoints of card tensors.  Needs a CUDA card: every test here carries
the ``gpu`` marker and skips without one.  It imports neither JAX nor the
``repro`` package, so it runs where only the port's dependencies are
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_train_gpu.py

Tolerances (TF32 off on the card, so both sides are IEEE f32 in other
orders of sums), as ``chip_smoke.py`` phase 23 states them: the loss within
1e-5; each gradient leaf within 2e-4 of its largest CPU entry (moving
every weight by one ulp moves the CPU's own gradients by 1.5e-4 of that,
``tests/test_torch_lm_train.py``); after AdamW every parameter within
``2 * lr`` and all but a fraction of 5e-3 within 1e-6 (Adam's first step
moves an entry by ``lr * g / (|g| + eps)``, so where a gradient is within a
few eps of zero its rounding moves the step by up to lr: 9.7e-4 of the
entries on an H100).  Checkpoints: bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.train import train_loop
from repro_torch.models.lm import LM, ModelImpl
from repro_torch.train import OptConfig, make_train_step, opt_init
from repro_torch.train.optimizer import map_tree, tree_leaves

ARCH = "granite-moe-1b-a400m"
LOSS_TOL = 1e-5
GRAD_RTOL = 2e-4
STEP_ATOL = 1e-6
STEP_FRACTION = 5e-3


@pytest.fixture
def cuda_device():
    """The first CUDA device, TF32 off; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _setup(dev):
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=torch.float32)
    plain = ModelImpl(attn="xla", ssd="xla", moe="xla")
    models = {"cpu": LM(cfg, plain, device="cpu"), "card": LM(cfg, plain,
                                                                device=dev)}
    params = models["cpu"].init(0)
    hb = SyntheticLMDataset(cfg.vocab_size, 64, 4, seed=0).batch_at(0)
    batches = {"cpu": {k: torch.from_numpy(v) for k, v in hb.items()},
               "card": {k: torch.from_numpy(v).to(dev) for k, v in hb.items()}}
    return models, params, batches


@pytest.mark.gpu
def test_loss_and_grads_card_match_cpu(cuda_device):
    models, params, batches = _setup(cuda_device)
    out = {}
    for side, dev in (("cpu", "cpu"), ("card", cuda_device)):
        p = map_tree(lambda t: t.to(dev), params)
        leaves = [t for _, t in tree_leaves(p)]
        for t in leaves:
            t.requires_grad_(True)
        loss = models[side].loss(p, batches[side])
        out[side] = [loss.detach().cpu()] + [
            g.cpu() for g in torch.autograd.grad(loss, leaves)]
    assert abs(float(out["card"][0]) - float(out["cpu"][0])) <= LOSS_TOL
    for (path, _), a, b in zip(tree_leaves(params), out["card"][1:],
                               out["cpu"][1:]):
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= GRAD_RTOL, (path, err)


@pytest.mark.gpu
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_card_matches_cpu(cuda_device, microbatches):
    models, params, batches = _setup(cuda_device)
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for side, dev in (("cpu", "cpu"), ("card", cuda_device)):
        p = map_tree(lambda t: t.to(dev, copy=True), params)
        out[side] = make_train_step(models[side], opt,
                                    microbatches=microbatches)(
            p, opt_init(p), batches[side])
    (pc, sc, mc), (pk, sk, mk) = out["cpu"], out["card"]
    assert abs(float(mk["loss"]) - float(mc["loss"])) <= LOSS_TOL
    assert abs(float(mk["gnorm"]) - float(mc["gnorm"])) <= \
        GRAD_RTOL * float(mc["gnorm"])
    assert int(sk["step"]) == int(sc["step"]) == 1
    lr = float(mc["lr"])
    loose = total = 0
    for (path, a), (_, b) in zip(tree_leaves(pk), tree_leaves(pc)):
        diff = (a.cpu() - b).abs()
        assert bool((diff <= 2 * lr + STEP_ATOL).all()), path
        loose += int((diff > STEP_ATOL).sum())
        total += diff.numel()
    assert loose <= STEP_FRACTION * total, (loose, total)


@pytest.mark.gpu
def test_checkpoint_of_card_tensors_round_trips(cuda_device, tmp_path):
    """bf16, f32 and int32 card tensors saved and restored onto the card,
    and onto the CPU, bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    tree = {"params": {"w": torch.randn(64, 32, generator=g,
                                        device=cuda_device).to(torch.bfloat16),
                       "scale": torch.randn(32, generator=g,
                                            device=cuda_device)},
            "opt": {"m": [torch.randn(64, 32, generator=g, device=cuda_device)],
                    "step": torch.tensor(7, dtype=torch.int32,
                                         device=cuda_device)}}
    save_checkpoint(str(tmp_path), 3, tree)
    back, step = load_checkpoint(str(tmp_path), tree)
    assert step == 3
    for (path, a), (_, b) in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.device == b.device and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    on_cpu, _ = load_checkpoint(str(tmp_path), tree, device="cpu")
    for (path, a), (_, b) in zip(tree_leaves(on_cpu), tree_leaves(tree)):
        assert a.device.type == "cpu" and torch.equal(a, b.cpu()), path


@pytest.mark.gpu
def test_train_loop_on_card_resumes(cuda_device, tmp_path):
    """``train_loop`` on the card (its default device): finite losses, and
    a restart from its checkpoint runs only the remaining steps."""
    kw = dict(smoke=True, batch=4, seq=32, log_every=0,
              ckpt_dir=str(tmp_path), ckpt_interval=2)
    first = train_loop(ARCH, steps=4, **kw)
    assert next(iter(first["params"]["embed"].values())).device.type == "cuda"
    again = train_loop(ARCH, steps=6, **kw)
    assert again["start_step"] == 4 and len(again["losses"]) == 2
    assert np.isfinite(first["losses"] + again["losses"]).all()

"""The port's hand-written CUDA kernels against their plain torch versions,
on the card.  Needs a CUDA card and ``nvcc`` (the kernels have no CPU mode):
every test here carries the ``gpu`` marker and skips without a card.  It
imports neither JAX nor the ``repro`` package, so it runs where only the
port's dependencies are installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance: atol 1e-5 on unit-scale f32 inputs (the same f32 sums in
another order; accurate ``tanhf``, no TF32)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, policy_mlp as pm, predict_mlp as qm
from repro_torch.kernels.batch_score import BucketedScorer
from repro_torch.kernels.ref import policy_mlp_ref, predict_mlp_ref

ATOL = 1e-5


@pytest.fixture
def cuda_device():
    """The first CUDA device, TF32 off; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(Q, F, H1, H2, device, seed):
    """Unit-scale inputs; every other row masked."""
    rng = np.random.default_rng(seed)
    layers = [{"w": torch.tensor(rng.normal(size=(a, b)), dtype=torch.float32,
                                 device=device),
               "b": torch.tensor(rng.normal(size=(b,)), dtype=torch.float32,
                                 device=device)}
              for a, b in ((F, H1), (H1, H2), (H2, 1))]
    x = torch.tensor(rng.normal(size=(Q, F)), dtype=torch.float32, device=device)
    mask = torch.tensor(np.arange(Q) % 2 == 0, dtype=torch.float32,
                        device=device)
    return x, layers, mask


def _flat(layers):
    return [t for lyr in layers for t in (lyr["w"], lyr["b"])]


@pytest.mark.gpu
@pytest.mark.parametrize("Q", [1, 256, 300, 2304, 4096, 16384])
@pytest.mark.parametrize("F,H1,H2", [(8, 64, 32), (8, 32, 16), (5, 40, 20)])
def test_policy_mlp_kernel_matches_plain_version(cuda_device, Q, F, H1, H2):
    x, layers, mask = _case(Q, F, H1, H2, cuda_device, seed=Q)
    before = pm.launches
    got = ops.policy_mlp(x, layers, mask)
    torch.cuda.synchronize()
    assert pm.launches == before + 1
    want = policy_mlp_ref(x, *_flat(layers), mask)
    assert (got - want).abs().max().item() <= ATOL
    assert (got[1::2] == -1e9).all()


@pytest.mark.gpu
def test_policy_mlp_kernel_rejects_bad_inputs(cuda_device):
    x, layers, mask = _case(64, 8, 64, 32, cuda_device, seed=1)
    flat = _flat(layers)
    with pytest.raises(TypeError):
        pm.policy_mlp(x.double(), *flat, mask)
    with pytest.raises(ValueError, match="contiguous"):
        pm.policy_mlp(x.t().contiguous().t(), *flat, mask)
    with pytest.raises(ValueError, match="shape"):
        pm.policy_mlp(x, *flat, mask[:10])
    with pytest.raises(ValueError, match="on cpu"):
        pm.policy_mlp(x, *flat, mask.cpu())
    wide = _case(64, 8, 64, 48, cuda_device, seed=2)
    with pytest.raises(ValueError, match="outside"):
        pm.policy_mlp(wide[0], *_flat(wide[1]), wide[2])


@pytest.mark.gpu
def test_bucketed_scorer_on_the_card(cuda_device):
    x, layers, _ = _case(2304, 8, 64, 32, cuda_device, seed=7)
    sc = BucketedScorer(layers)
    got = sc.score(x.cpu().numpy())
    want = policy_mlp_ref(x, *_flat(layers),
                          torch.ones(2304, device=cuda_device)).cpu().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert sc.compiled_buckets == (4096,)


def _predict_case(B, F, H1, H2, Q, device, seed):
    """Unit-scale inputs and weights, the head included (a zero head, as the
    predictor initialises it, would hide every error)."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=device)
    params = {"w1": t(F, H1), "b1": t(H1), "w2": t(H1, H2), "b2": t(H2),
              "w3": t(H2, Q), "b3": t(Q)}
    return t(B, F), params


_PARAM_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 8, 300, 1103, 2560, 16384])
@pytest.mark.parametrize("F,H1,H2,Q", [(21, 24, 12, 2), (5, 16, 7, 1)])
def test_predict_mlp_kernel_matches_plain_version(cuda_device, B, F, H1, H2,
                                                  Q):
    x, params = _predict_case(B, F, H1, H2, Q, cuda_device, seed=B)
    before = qm.launches
    got = ops.predict_mlp(x, params)
    torch.cuda.synchronize()
    assert qm.launches == before + 1
    want = predict_mlp_ref(x, *(params[k] for k in _PARAM_KEYS))
    assert got.shape == (B, Q)
    assert (got - want).abs().max().item() <= ATOL


@pytest.mark.gpu
def test_predict_mlp_kernel_rejects_bad_inputs(cuda_device):
    x, params = _predict_case(64, 21, 24, 12, 2, cuda_device, seed=1)
    flat = [params[k] for k in _PARAM_KEYS]
    with pytest.raises(TypeError):
        qm.predict_mlp(x.double(), *flat)
    with pytest.raises(ValueError, match="contiguous"):
        qm.predict_mlp(x.t().contiguous().t(), *flat)
    with pytest.raises(ValueError, match="shape"):
        qm.predict_mlp(x, *flat[:5], flat[5][:1])
    with pytest.raises(ValueError, match="on cpu"):
        qm.predict_mlp(x, *flat[:5], flat[5].cpu())
    wide = _predict_case(64, 21, 24, 12, 3, cuda_device, seed=2)
    with pytest.raises(ValueError, match="outside"):
        qm.predict_mlp(wide[0], *(wide[1][k] for k in _PARAM_KEYS))


@pytest.mark.gpu
def test_runtime_predictor_on_the_card_matches_the_cpu(cuda_device):
    """The same completions through a predictor on the card and one on the
    CPU: identical training, and quantiles within rtol 1e-6 right after
    every SGD step (the card's weight copy must follow each step)."""
    from repro_torch.core import generate_trace
    from repro_torch.predict import RuntimePredictor

    jobs = generate_trace("helios", 120, seed=4)
    preds = [RuntimePredictor(device=d) for d in ("cuda", "cpu")]
    for k, job in enumerate(jobs):
        for p in preds:
            p.on_submit(job, job.submit_time)
            if k >= 10:
                p.on_finish(jobs[k - 10], jobs[k - 10].submit_time)
        if k >= 10:
            window = jobs[max(0, k - 40):k + 1]
            for got, want in zip(preds[0].predict_quantiles(window),
                                 preds[1].predict_quantiles(window)):
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert preds[0].mape() == preds[1].mape()
    assert preds[0]._dev_params["w3"].device.type == "cuda"

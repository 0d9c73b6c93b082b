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

from repro_torch.kernels import ops, policy_mlp as pm
from repro_torch.kernels.batch_score import BucketedScorer
from repro_torch.kernels.ref import policy_mlp_ref

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

"""The port's fused policy-MLP module against the JAX package's.

On the CPU ``repro_torch.kernels.ops.policy_mlp`` runs the plain torch
version (``ref.policy_mlp_ref``); it is held to the Pallas kernel run as
``tests/test_kernels.py`` runs it (interpret mode through
``repro.kernels.ops``) and to ``repro.core.agent.actor_logits``, within
atol 1e-5 (the bound of ``test_kernels.py::test_policy_mlp_sweep``: f32
sums in another order).  The CUDA kernel itself is compared with the plain
version on the card by ``test_torch_kernels_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import agent as j_agent
from repro.kernels import ops as j_ops
from repro.kernels.batch_score import BucketedScorer as JBucketedScorer
from repro_torch.kernels import ops, policy_mlp as pm
from repro_torch.kernels.batch_score import BucketedScorer, bucket_for
from repro_torch.kernels.ref import policy_mlp_ref

ATOL = 1e-5

# (Q, F, H1, H2): the sweep of test_kernels.py plus ragged queue depths
# (300 pads to the 512 bucket; 2,304 is the deepest tail of a Philly run)
SHAPES = [(256, 8, 64, 32), (128, 8, 32, 16), (300, 8, 64, 32),
          (2304, 8, 64, 32)]


def _case(Q, F, H1, H2, seed=0):
    """Unit-scale numpy inputs; the first half of the rows unmasked."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.normal(size=(Q, F)).astype(f32)
    layers = [{"w": rng.normal(size=(a, b)).astype(f32),
               "b": rng.normal(size=(b,)).astype(f32)}
              for a, b in ((F, H1), (H1, H2), (H2, 1))]
    mask = (np.arange(Q) < Q // 2).astype(f32)
    return x, layers, mask


def _torch_layers(layers, device="cpu"):
    return [{k: torch.tensor(v, device=device) for k, v in lyr.items()}
            for lyr in layers]


def _flat(layers):
    return [t for lyr in layers for t in (lyr["w"], lyr["b"])]


@pytest.mark.parametrize("Q,F,H1,H2", SHAPES)
def test_policy_mlp_matches_pallas_and_actor_logits(Q, F, H1, H2):
    x, layers, mask = _case(Q, F, H1, H2)
    got = ops.policy_mlp(torch.tensor(x), _torch_layers(layers),
                         torch.tensor(mask)).numpy()
    jl = [{k: jnp.asarray(v) for k, v in lyr.items()} for lyr in layers]
    pallas = np.asarray(j_ops.policy_mlp(jnp.asarray(x), jl, jnp.asarray(mask)))
    logits = np.asarray(j_agent.actor_logits({"actor": jl}, jnp.asarray(x),
                                             jnp.asarray(mask)))
    assert got.shape == (Q,) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, logits, atol=ATOL, rtol=0)
    assert (got[Q // 2:] == np.float32(-1e9)).all()


def _policy_kernel_emulation(x, w1, b1, w2, b2, w3, b3, mask):
    """The CUDA kernel's order of work, on the CPU: the net zero-padded to
    8 -> 64 -> 32 -> 1 (as the kernel stages any smaller one), every
    first-layer unit one chain of FMAs over the features in order, every
    second-layer unit one chain over the 64 hidden units in order (as the
    row's eight lanes hand them over by shuffles), the logit one chain over
    the 32 second-layer values in order (handed over the same way), then
    the bias.  An f32 FMA is taken through float64, where the product is
    exact."""
    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()

    def pad(t, *shape):
        out = torch.zeros(shape)
        out[tuple(slice(0, n) for n in t.shape)] = t
        return out
    Q = x.shape[0]
    x, w1, b1 = pad(x, Q, 8), pad(w1, 8, 64), pad(b1, 64)
    w2, b2, w3 = pad(w2, 64, 32), pad(b2, 32), pad(w3[:, 0], 32)
    a1 = torch.zeros((Q, 64))
    for f in range(8):
        a1 = fma(x[:, f:f + 1], w1[f][None], a1)
    h1 = torch.tanh(a1 + b1)
    a2 = torch.zeros((Q, 32))
    for j in range(64):
        a2 = fma(h1[:, j:j + 1], w2[j][None], a2)
    g = torch.tanh(a2 + b2)
    logits = torch.zeros(Q)
    for k in range(32):
        logits = fma(g[:, k], w3[k], logits)
    logits = logits + b3
    return torch.where(mask > 0, logits, torch.full_like(logits, -1e9))


@pytest.mark.parametrize("Q", [1, 256, 300])
@pytest.mark.parametrize("F,H1,H2", [(8, 64, 32), (8, 32, 16), (5, 40, 20)])
def test_policy_kernel_arithmetic_matches_plain_and_pallas(Q, F, H1, H2):
    """The kernel's order of work (emulated on the CPU; its eight lanes a
    row hand hidden values over in a fixed order) against the plain version
    and the Pallas kernel (interpret mode), within 1e-5, on the actor's net
    and the two padded ones the card's tests use."""
    x, layers, mask = _case(Q, F, H1, H2, seed=Q + H1)
    mask[0] = 1.0                       # Q 1: one live row
    tl = _torch_layers(layers)
    args = (torch.tensor(x), *_flat(tl), torch.tensor(mask))
    got = _policy_kernel_emulation(*args)
    want = policy_mlp_ref(*args)
    jl = [{k: jnp.asarray(v) for k, v in lyr.items()} for lyr in layers]
    pallas = np.asarray(j_ops.policy_mlp(jnp.asarray(x), jl, jnp.asarray(mask)))
    live = mask > 0
    assert got.shape == (Q,) and np.abs(got.numpy()[live]).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL, rtol=0)


def test_cpu_dispatch_is_the_plain_version():
    x, layers, mask = _case(256, 8, 64, 32)
    tl = _torch_layers(layers)
    via_ops = ops.policy_mlp(torch.tensor(x), tl, torch.tensor(mask))
    direct = policy_mlp_ref(torch.tensor(x), *_flat(tl), torch.tensor(mask))
    assert torch.equal(via_ops, direct)


def test_dispatch_rejects_other_and_mixed_devices():
    x, layers, mask = _case(16, 8, 32, 16)
    meta = [{k: torch.empty(v.shape, device="meta") for k, v in lyr.items()}
            for lyr in layers]
    with pytest.raises(ValueError, match="device type"):
        ops.policy_mlp(torch.empty(x.shape, device="meta"), meta,
                       torch.empty(mask.shape, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        ops.policy_mlp(torch.tensor(x), meta, torch.tensor(mask))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper never falls back: CPU tensors are an error there (the
    CPU path is chosen by ops), and nothing is built or launched."""
    x, layers, mask = _case(16, 8, 32, 16)
    before = pm.launches
    with pytest.raises(ValueError, match="CUDA"):
        pm.policy_mlp(torch.tensor(x), *_flat(_torch_layers(layers)),
                      torch.tensor(mask))
    assert pm.launches == before


def test_bucket_ladder_matches_reference():
    from repro.kernels.batch_score import bucket_for as j_bucket_for
    for n in (1, 255, 256, 257, 300, 2304, 4096, 5000, 16384, 10 ** 6):
        assert bucket_for(n) == j_bucket_for(n)
    assert bucket_for(2304) == 4096
    assert bucket_for(10 ** 6) == 16384


@pytest.mark.parametrize("n", [300, 2304])
def test_bucketed_scorer_matches_reference(n):
    """Same logits (atol 1e-5) and the same bucket bookkeeping as the
    reference scorer over the Pallas kernel."""
    x, layers, _ = _case(n, 8, 64, 32, seed=3)
    jl = [{k: jnp.asarray(v) for k, v in lyr.items()} for lyr in layers]
    js, ts = JBucketedScorer(jl), BucketedScorer(_torch_layers(layers))
    want, got = js.score(x), ts.score(x)
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert ts.compiled_buckets == js.compiled_buckets == (bucket_for(n),)
    # a nearby depth reuses the bucket; an empty batch scores nothing
    js.score(x[: n - 7])
    ts.score(x[: n - 7])
    assert ts.compiled_buckets == js.compiled_buckets
    assert ts.score(x[:0]).shape == (0,)


def test_bucketed_scorer_chunks_beyond_max_bucket():
    x, layers, _ = _case(700, 8, 32, 16, seed=5)
    jl = [{k: jnp.asarray(v) for k, v in lyr.items()} for lyr in layers]
    js = JBucketedScorer(jl, max_bucket=256)
    ts = BucketedScorer(_torch_layers(layers), max_bucket=256)
    np.testing.assert_allclose(ts.score(x), js.score(x), atol=ATOL, rtol=0)
    assert ts.compiled_buckets == js.compiled_buckets == (256,)

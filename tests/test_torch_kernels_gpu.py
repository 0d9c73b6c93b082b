"""The port's hand-written CUDA kernels against their plain torch versions,
on the card.  Needs a CUDA card and ``nvcc`` (the kernels have no CPU mode):
every test here carries the ``gpu`` marker and skips without a card.  It
imports neither JAX nor the ``repro`` package, so it runs where only the
port's dependencies are installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance for the MLP kernels: atol 1e-5 on unit-scale f32 inputs (the
same f32 sums in another order; accurate ``tanhf``, no TF32); the LM
kernels' tolerances are stated above their tests."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa, moe_router as mr
from repro_torch.kernels import ops, policy_mlp as pm, predict_mlp as qm
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.batch_score import BucketedScorer
from repro_torch.kernels.ref import (flash_attention_ref, moe_router_ref,
                                     policy_mlp_ref, predict_mlp_ref,
                                     ssd_scan_ref)

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
@pytest.mark.parametrize("Q", [1, 255, 256, 257, 300, 2304, 4096, 16384])
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
@pytest.mark.parametrize("Q", [1, 300])
def test_policy_mlp_kernel_unaligned_actor(cuda_device, Q):
    """The actor's own widths on inputs that start 4 bytes off a 16-byte
    boundary run the padded instantiation (the exact one needs 16-byte
    vector loads) and agree with the plain version all the same."""
    x, layers, mask = _case(Q, 8, 64, 32, cuda_device, seed=Q + 1)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=cuda_device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    xs = shifted(x)
    ls = [{k: shifted(v) for k, v in lyr.items()} for lyr in layers]
    assert xs.is_contiguous() and xs.data_ptr() % 16 != 0
    got = ops.policy_mlp(xs, ls, mask)
    want = policy_mlp_ref(x, *_flat(layers), mask)
    assert (got - want).abs().max().item() <= ATOL


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


# ------------------------------------------------- LM serving kernels --
# Tolerances: f32 flash attention 2e-5 and SSD scan 2e-3 (true f32 sums in
# another order, no TF32); bf16 2e-2 (the output is rounded to bf16 on both
# sides, and one bf16 step at |x| < 2 is 2^-7); router weights 1e-5 and the
# same expert sets wherever the k-th and (k+1)-th logits are more than 1e-4
# apart, the same order wherever all the top k + 1 are (the kernel and the
# plain version sum d = 4096 products in different orders).

_LM_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _randn(rng, shape, device, dtype=torch.float32, scale=1.0):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32,
                        device=device).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,KV,L,D,window", [
    (1, 32, 8, 512, 128, 0),      # jamba / qwen3-moe: GQA 4, D 128
    (2, 16, 16, 300, 64, 0),      # mamba-free dense, ragged L
    (1, 32, 32, 256, 80, 0),      # h2o-danube: D 80
    (2, 12, 2, 200, 64, 0),       # GQA 6
    (1, 16, 1, 130, 64, 0),       # GQA 16
    (1, 32, 8, 1100, 80, 1000),   # sliding window, first tiles fully masked
    (1, 8, 8, 4200, 128, 4096),   # h2o-danube window 4096
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_version(cuda_device, B, H, KV, L,
                                                      D, window, dtype):
    rng = np.random.default_rng(L + D)
    q = _randn(rng, (B, H, L, D), cuda_device, dtype)
    k = _randn(rng, (B, KV, L, D), cuda_device, dtype)
    v = _randn(rng, (B, KV, L, D), cuda_device, dtype)
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=True, window=window)
    assert got.dtype == dtype and got.shape == want.shape
    tol = _LM_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [50, 72, 96, 112])
@pytest.mark.parametrize("aligned", [True, False])
def test_flash_attention_bf16_kernel_other_head_dims(cuda_device, D, aligned):
    """Head dims the bf16 kernel runs in the next instantiated width up
    (zero-filled in shared memory), on 16-byte aligned inputs (cp.async
    copies where D % 8 == 0) and on inputs that start 2 bytes off (element
    loads and stores)."""
    rng = np.random.default_rng(D)
    B, H, KV, L = 1, 8, 2, 333

    def tensor(n):
        t = _randn(rng, (B * n * L * D + 1,), cuda_device, torch.bfloat16)
        return (t[:-1] if aligned else t[1:]).view(B, n, L, D)
    q, k, v = tensor(H), tensor(KV), tensor(KV)
    assert q.is_contiguous() and (q.data_ptr() % 16 == 0) == aligned
    got = ops.flash_attention(q, k, v, causal=True, window=100)
    want = flash_attention_ref(q, k, v, causal=True, window=100)
    tol = _LM_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_flash_attention_kernel_rejects_bad_inputs(cuda_device):
    rng = np.random.default_rng(0)
    q = _randn(rng, (1, 4, 64, 32), cuda_device)
    k = _randn(rng, (1, 2, 64, 32), cuda_device)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention(q, k[:, :, :32], k)
    with pytest.raises(ValueError, match="on cpu"):
        fa.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, k)
    with pytest.raises(ValueError, match="outside"):
        fa.flash_attention(_randn(rng, (1, 3, 64, 32), cuda_device), k, k)
    big = _randn(rng, (1, 2, 8, 192), cuda_device)
    with pytest.raises(ValueError, match="outside"):
        fa.flash_attention(big, big, big)


def _ssd_case(B, L, H, P, N, device, dtype, seed, init=False):
    rng = np.random.default_rng(seed)
    xh = _randn(rng, (B, L, H, P), device, dtype, 0.5)
    dt = torch.nn.functional.softplus(_randn(rng, (B, L, H), device))
    A = -torch.exp(_randn(rng, (H,), device, scale=0.3))
    Bs = _randn(rng, (B, L, N), device, dtype, 0.3)
    Cs = _randn(rng, (B, L, N), device, dtype, 0.3)
    S0 = _randn(rng, (B, H, P, N), device, scale=0.3) if init else None
    return xh, dt, A, Bs, Cs, S0


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (1, 2048, 128, 64, 16, 256),  # jamba, one row of the serve batch
    (2, 512, 128, 64, 16, 256),   # jamba
    (1, 512, 48, 64, 128, 256),   # mamba2-780m
    (1, 200, 4, 64, 128, 256),    # L shorter than the chunk, off the tile
    (2, 192, 3, 32, 16, 64),
    (1, 1, 4, 64, 16, 256),       # one step
    (1, 65, 5, 64, 128, 256),     # one step past the kernels' 64-step chunk
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_scan_kernel_matches_plain_version(cuda_device, B, L, H, P, N,
                                               chunk, dtype, init):
    xh, dt, A, Bs, Cs, S0 = _ssd_case(B, L, H, P, N, cuda_device, dtype,
                                      seed=L + N, init=init)
    before = ss.launches
    y, S = ops.ssd_scan(xh, dt, A, Bs, Cs, chunk=chunk, init_state=S0)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    y_want, S_want = ssd_scan_ref(xh, dt, A, Bs, Cs, S0)
    assert y.dtype == dtype and S.dtype == torch.float32
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), y_want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(S, S_want, atol=2e-3, rtol=2e-3)


@pytest.mark.gpu
def test_ssd_scan_kernel_rejects_bad_inputs(cuda_device):
    xh, dt, A, Bs, Cs, _ = _ssd_case(1, 64, 2, 16, 16, cuda_device,
                                     torch.float32, seed=1)
    with pytest.raises(TypeError):
        ss.ssd_scan(xh.double(), dt, A, Bs, Cs)
    with pytest.raises(TypeError):
        ss.ssd_scan(xh, dt.bfloat16(), A, Bs, Cs)
    with pytest.raises(ValueError, match="shape"):
        ss.ssd_scan(xh, dt, A[:1], Bs, Cs)
    with pytest.raises(ValueError, match="on cpu"):
        ss.ssd_scan(xh, dt, A.cpu(), Bs, Cs)
    with pytest.raises(ValueError, match="shape"):
        ss.ssd_scan(xh, dt, A, Bs, Cs, torch.zeros(1, 2, 16, 8,
                                                   device=cuda_device))
    wide = _ssd_case(1, 64, 2, 128, 16, cuda_device, torch.float32, seed=2)
    with pytest.raises(ValueError, match="outside"):
        ss.ssd_scan(*wide[:5])
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(xh[:, :48], dt[:, :48], A, Bs[:, :48], Cs[:, :48],
                     chunk=32)


def _router_agrees(x, w, k, got_w, got_i):
    """Where the k-th and (k+1)-th plain logits are more than 1e-4 apart:
    the same set of experts, weights within 1e-5 (in the kernel's order);
    where every gap among the top k + 1 exceeds 1e-4: the same experts in
    the same order."""
    want_w, want_i = moe_router_ref(x, w, k)
    E = w.shape[1]
    top = torch.sort(x.float() @ w, dim=-1, descending=True).values
    gaps = top[:, :min(k + 1, E)].diff(dim=-1).neg()
    set_sep = (gaps[:, k - 1] > 1e-4 if k < E
               else torch.ones_like(top[:, 0], dtype=torch.bool))
    ord_sep = (gaps > 1e-4).all(dim=-1)
    if len(set_sep) >= 100:
        assert set_sep.float().mean().item() > 0.9
    assert torch.equal(got_i[set_sep].sort(dim=-1).values,
                       want_i[set_sep].sort(dim=-1).values)
    assert torch.equal(got_i[ord_sep], want_i[ord_sep])
    assert ((got_w - want_w)[set_sep].abs() <= 1e-5).all()


# both sides of each route's crossover: split up to T 384 (bf16) or 1,536
# (f32), mma (bf16) or tiled (f32) above
_ROUTER_TS = [1, 2, 4, 64, 65, 257, 300, 1024, 8192]
_ROUTER_SHAPES = [(4096, 16, 2), (1024, 32, 8), (4096, 128, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("T", _ROUTER_TS)
@pytest.mark.parametrize("d,E,k", _ROUTER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_router_kernel_matches_plain_version(cuda_device, T, d, E, k,
                                                 dtype):
    rng = np.random.default_rng(T + E)
    x = _randn(rng, (T, d), cuda_device, dtype)
    w = _randn(rng, (d, E), cuda_device, scale=0.1 / np.sqrt(d))
    before = mr.launches
    got_w, got_i = ops.moe_router(x, w, k)
    torch.cuda.synchronize()
    assert mr.launches == before + 1
    assert got_i.dtype == torch.int32 and got_w.shape == (T, k)
    _router_agrees(x, w, k, got_w, got_i)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [4, 300, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_router_kernel_breaks_ties_to_the_lowest_expert(cuda_device, T,
                                                            dtype):
    rng = np.random.default_rng(3)
    x = _randn(rng, (T, 256), cuda_device, dtype)
    w = _randn(rng, (256, 16), cuda_device, scale=0.1)
    w[:, 8:] = w[:, :8]                     # every logit appears twice
    got_w, got_i = mr.moe_router(x, w, 2)
    want_w, want_i = moe_router_ref(x, w, 2)
    assert torch.equal(got_i, want_i)
    assert (got_i[:, 1] == got_i[:, 0] + 8).all()
    torch.testing.assert_close(got_w, want_w, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_moe_router_kernel_rejects_bad_inputs(cuda_device):
    rng = np.random.default_rng(0)
    x = _randn(rng, (16, 64), cuda_device)
    w = _randn(rng, (64, 8), cuda_device)
    with pytest.raises(TypeError):
        mr.moe_router(x.double(), w, 2)
    with pytest.raises(TypeError):
        mr.moe_router(x, w.bfloat16(), 2)
    with pytest.raises(ValueError, match="shape"):
        mr.moe_router(x, w[:32], 2)
    with pytest.raises(ValueError, match="on cpu"):
        mr.moe_router(x, w.cpu(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        mr.moe_router(x.t().contiguous().t(), w, 2)
    with pytest.raises(ValueError, match="outside"):
        mr.moe_router(x, w, 9)


def _router_inputs(T, d, E, device, dtype, seed):
    rng = np.random.default_rng(seed)
    return (_randn(rng, (T, d), device, dtype),
            _randn(rng, (d, E), device, scale=0.1 / np.sqrt(d)))


@pytest.mark.gpu
@pytest.mark.parametrize("route,dtype", [
    ("split", torch.float32), ("split", torch.bfloat16),
    ("tiled", torch.float32), ("tiled", torch.bfloat16),
    ("mma", torch.bfloat16)])
@pytest.mark.parametrize("T", [4, 300, 1024])
@pytest.mark.parametrize("d,E,k", _ROUTER_SHAPES)
def test_moe_router_every_route_matches_plain_version(cuda_device, route,
                                                      dtype, T, d, E, k):
    """Each of the three routes, forced, on both sides of the crossovers."""
    x, w = _router_inputs(T, d, E, cuda_device, dtype, seed=T + E)
    got_w, got_i = mr.run(x, w, k, route)
    torch.cuda.synchronize()
    _router_agrees(x, w, k, got_w, got_i)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [4, 300, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_router_kernel_is_deterministic(cuda_device, T, dtype):
    """Two calls on the same inputs give the same bits (no atomics)."""
    x, w = _router_inputs(T, 4096, 16, cuda_device, dtype, seed=T)
    a_w, a_i = mr.moe_router(x, w, 2)
    b_w, b_i = mr.moe_router(x, w, 2)
    torch.cuda.synchronize()
    assert torch.equal(a_w, b_w) and torch.equal(a_i, b_i)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [4, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_router_graph_replays_give_the_same_result(cuda_device, T,
                                                       dtype):
    """A captured CUDA graph of the router, replayed twice, gives the eager
    call's bits both times."""
    x, w = _router_inputs(T, 4096, 16, cuda_device, dtype, seed=T + 1)
    want_w, want_i = mr.moe_router(x, w, 2)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        mr.moe_router(x, w, 2)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_w, out_i = mr.moe_router(x, w, 2)
    for _ in range(2):
        out_w.zero_()
        out_i.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out_w, want_w) and torch.equal(out_i, want_i)


@pytest.mark.gpu
@pytest.mark.parametrize("T,dtype,route,n", [
    (4, torch.bfloat16, "split", 2), (300, torch.float32, "split", 2),
    (8192, torch.bfloat16, "mma", 2), (8192, torch.float32, "tiled", 1)])
def test_moe_router_kernels_per_call(cuda_device, T, dtype, route, n):
    """route() and kernels_per_call() say what one call launches, and the
    profiler sees that many router kernels; ``launches`` counts the call
    once."""
    from torch.profiler import ProfilerActivity, profile
    assert mr.route(T, 4096, 16, dtype) == route
    assert mr.kernels_per_call(T, 4096, 16, dtype) == n
    x, w = _router_inputs(T, 4096, 16, cuda_device, dtype, seed=2)
    mr.moe_router(x, w, 2)
    torch.cuda.synchronize()
    before = mr.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mr.moe_router(x, w, 2)
        torch.cuda.synchronize()
    assert mr.launches == before + 1
    assert sum(e.count for e in prof.key_averages()
               if "moe_router" in e.key) == n


@pytest.mark.gpu
def test_moe_router_takes_an_unaligned_x(cuda_device):
    """A contiguous bf16 x whose rows are not 16-byte aligned goes to the
    tiled route (the mma route's copies need aligned rows, and refuses it
    when forced)."""
    T, d = 8192, 4096
    rng = np.random.default_rng(5)
    flat = _randn(rng, (T * d + 1,), cuda_device, torch.bfloat16)
    x = flat[1:].view(T, d)
    w = _randn(rng, (d, 16), cuda_device, scale=0.1 / np.sqrt(d))
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got_w, got_i = mr.moe_router(x, w, 2)
    torch.cuda.synchronize()
    _router_agrees(x, w, 2, got_w, got_i)
    with pytest.raises(RuntimeError, match="launch failed"):
        mr.run(x, w, 2, "mma")

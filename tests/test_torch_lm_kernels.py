"""The plain versions of the port's LM kernels against the JAX package's
Pallas kernels (interpret mode on the CPU), at the sweep shapes and
tolerances of ``tests/test_kernels.py``.

The plain versions are what the port runs on the CPU and what
``chip_smoke.py`` and ``tests/test_torch_kernels_gpu.py`` hold the CUDA
kernels to on the card.  Inputs come from numpy with a fixed seed; bf16
inputs are the same f32 numbers rounded to bf16 on both sides.

Tolerances: flash attention 2e-5 (f32) / 2e-2 (bf16); SSD scan 2e-3 (f32)
/ 5e-2 (bf16), as the reference's sweeps; router weights 1e-5 and router
indices exactly equal, ties included (both take the lowest expert index).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (flash_attention_ref, moe_router_ref,
                                     ssd_scan_ref)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same numbers as a jax array and a CPU tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,H,KV,L,D", [
    (1, 2, 2, 128, 64),
    (2, 4, 2, 256, 64),
    (1, 8, 2, 128, 128),
    (2, 2, 1, 256, 80),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 64])
def test_flash_attention_ref_matches_pallas(B, H, KV, L, D, dtype, window):
    rng = np.random.default_rng(B * 1000 + H * 10 + D)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, L, D), (B, KV, L, D), (B, KV, L, D))]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrs)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                block_q=64, block_k=64)
    got = flash_attention_ref(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype and got.shape == (B, H, L, D)
    tol = 2e-2 if dtype == "bf16" else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("H,KV,L,D,window", [(6, 1, 100, 80, 0),
                                             (16, 1, 77, 64, 0),
                                             (8, 8, 130, 128, 40)])
def test_flash_attention_ref_ragged_and_grouped(H, KV, L, D, window):
    """Lengths off any tile, GQA groups of 6 and 16, against the
    reference's jnp oracle (the Pallas wrapper needs whole blocks)."""
    rng = np.random.default_rng(L)
    q = rng.standard_normal((1, H, L, D)).astype(np.float32)
    k = rng.standard_normal((1, KV, L, D)).astype(np.float32)
    v = rng.standard_normal((1, KV, L, D)).astype(np.float32)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=window)
    kr = np.repeat(k, H // KV, axis=1).reshape(H, L, D)
    vr = np.repeat(v, H // KV, axis=1).reshape(H, L, D)
    want = jref.flash_attention_ref(jnp.asarray(q.reshape(H, L, D)),
                                    jnp.asarray(kr), jnp.asarray(vr),
                                    causal=True, window=window)
    np.testing.assert_allclose(_f32(got).reshape(H, L, D), _f32(want),
                               atol=2e-5, rtol=2e-5)


def _ssd_inputs(B, L, H, P, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    xh = (rng.standard_normal((B, L, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bs = (rng.standard_normal((B, L, N)) * 0.3).astype(np.float32)
    Cs = (rng.standard_normal((B, L, N)) * 0.3).astype(np.float32)
    jx, tx = _pair(xh, dtype)
    jB, tB = _pair(Bs, dtype)
    jC, tC = _pair(Cs, dtype)
    j = (jx, jnp.asarray(dt), jnp.asarray(A), jB, jC)
    t = (tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC)
    return j, t


@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (1, 64, 2, 16, 32, 16),
    (2, 128, 4, 32, 64, 32),
    (1, 256, 2, 64, 128, 64),
    (2, 128, 3, 64, 16, 128),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssd_scan_ref_matches_pallas(B, L, H, P, N, chunk, dtype):
    j, t = _ssd_inputs(B, L, H, P, N, dtype, seed=L + N)
    y_want, S_want = jops.ssd_scan(*j, chunk=chunk)
    y_got, S_got = ssd_scan_ref(*t)
    assert y_got.dtype == t[0].dtype and S_got.dtype == torch.float32
    assert S_got.shape == (B, H, P, N)
    tol = 5e-2 if dtype == "bf16" else 2e-3
    np.testing.assert_allclose(_f32(y_got), _f32(y_want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(S_got), _f32(S_want), atol=tol, rtol=tol)


def test_ssd_scan_ref_init_state_matches_pallas():
    """Running [first half; second half with carried state] == full run,
    and the second half equals the reference's run from the same state."""
    B, L, H, P, N = 1, 128, 2, 16, 32
    j, t = _ssd_inputs(B, L, H, P, N, "f32", seed=5)
    y_full, S_full = ssd_scan_ref(*t)
    h = L // 2
    first = [a[:, :h] if a.dim() > 1 else a for a in t]
    second = [a[:, h:] if a.dim() > 1 else a for a in t]
    y1, S1 = ssd_scan_ref(*first)
    y2, S2 = ssd_scan_ref(*second, init_state=S1)
    np.testing.assert_allclose(y2.numpy(), y_full[:, h:].numpy(), atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(S2.numpy(), S_full.numpy(), atol=2e-3,
                               rtol=2e-3)
    jsecond = [a[:, h:] if a.ndim > 1 else a for a in j]
    jy2, jS2 = jops.ssd_scan(*jsecond, chunk=32,
                             init_state=jnp.asarray(S1.numpy()))
    np.testing.assert_allclose(y2.numpy(), _f32(jy2), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(S2.numpy(), _f32(jS2), atol=2e-3, rtol=2e-3)


def test_ssd_scan_rejects_a_ragged_length():
    _, t = _ssd_inputs(1, 96, 2, 16, 16, "f32")
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(*t, chunk=64)


def _router_inputs(T, d, E, seed, dup=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((d, E)) * 0.1).astype(np.float32)
    if dup:                      # exact ties: duplicated router columns
        w[:, E // 2:] = w[:, :E - E // 2]
    return x, w


@pytest.mark.parametrize("T,d,E,k,dup", [(256, 64, 16, 2, False),
                                         (512, 32, 8, 4, False),
                                         (512, 128, 64, 8, False),
                                         (256, 64, 16, 2, True),
                                         (256, 32, 8, 5, True)])
def test_moe_router_ref_matches_pallas(T, d, E, k, dup):
    x, w = _router_inputs(T, d, E, seed=T + E, dup=dup)
    jw, ji = jops.moe_router(jnp.asarray(x), jnp.asarray(w), k)
    tw, ti = moe_router_ref(torch.from_numpy(x), torch.from_numpy(w), k)
    assert ti.dtype == torch.int32 and tw.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    if dup:                      # every first pick is the lower copy
        assert (ti.numpy()[:, 0] < E - E // 2).all()


def test_ops_dispatch_rejects_mixed_and_unknown_devices():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(q, q.to("meta"), q)
    with pytest.raises(ValueError, match="device type"):
        ops.moe_router(torch.zeros(4, 8, device="meta"),
                       torch.zeros(8, 4, device="meta"), 2)

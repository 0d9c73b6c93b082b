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
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import flash_attention as fa, ops
from repro_torch.kernels.ref import (flash_attention_ref, moe_router_ref,
                                     ssd_init_share, ssd_scan_ref)

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


def _flash_bf16_emulation(q, k, v, *, causal, window):
    """The bf16 tensor-core kernel's order of work, on the CPU: per 64-row
    query tile (one warpgroup's rows), the 64-key tiles it visits (zero past
    L and masked), S in f32 from the bf16 q and k scaled to the log2
    domain, masked scores -1e30, the online max and sum of the f32 P, P
    rounded to bf16 before P V, the final divide (denominator clamped at
    1e-30), the output rounded to bf16.  (A block of the kernel visits the
    tiles of its four warpgroups' rows together; the tiles a warpgroup's
    rows see wholly masked after a real score add exactly 0, and those
    before one are washed out, so the result is the same.)"""
    B, H, L, D = q.shape
    G = H // k.shape[1]
    BQ, BK = 64, 64
    scale = (torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
             * torch.tensor(math.log2(math.e), dtype=torch.float32))
    qf = q.float()
    Lk = -(-L // BK) * BK + BK
    kf, vf = (torch.nn.functional.pad(t.float().repeat_interleave(G, dim=1),
                                      (0, 0, 0, Lk - L)) for t in (k, v))
    out = torch.empty((B, H, L, D), dtype=torch.float32)
    for q0 in range(0, L, BQ):
        rows = torch.arange(q0, min(q0 + BQ, L))[:, None]
        lo, hi = 0, L
        if causal:
            hi = min(L, q0 + BQ)
        if window:
            lo = max(0, q0 - window + 1)
        lo = lo // BK * BK
        m = torch.full((B, H, len(rows)), -1e30)
        lsum = torch.zeros((B, H, len(rows)))
        acc = torch.zeros((B, H, len(rows), D))
        for k0 in range(lo, hi, BK):
            keys = torch.arange(k0, k0 + BK)[None, :]
            s = (qf[:, :, q0:q0 + len(rows)]
                 @ kf[:, :, k0:k0 + BK].transpose(-1, -2)) * scale
            keep = keys < L
            if causal:
                keep = keep & (keys <= rows)
            if window:
                keep = keep & (keys > rows - window)
            s = torch.where(keep, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            lsum = lsum * alpha + p.sum(dim=-1)
            acc = (acc * alpha[..., None]
                   + p.bfloat16().float() @ vf[:, :, k0:k0 + BK])
            m = m_new
        out[:, :, q0:q0 + len(rows)] = acc / lsum.clamp_min(1e-30)[..., None]
    return out.to(torch.bfloat16)


def _flash_inputs(B, H, KV, L, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, L, D), (B, KV, L, D), (B, KV, L, D))]


@pytest.mark.parametrize("B,H,KV,L,D", [(1, 8, 2, 256, 64),
                                        (2, 4, 1, 128, 80)])
@pytest.mark.parametrize("window", [0, 64])
def test_flash_bf16_kernel_arithmetic_matches_plain_and_pallas(B, H, KV, L,
                                                               D, window):
    """The bf16 kernel's arithmetic (emulated on the CPU, GQA 4) against
    the plain version and the Pallas kernel (interpret mode) at the bf16
    tolerance, 2e-2."""
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "bf16") for a in
                                    _flash_inputs(B, H, KV, L, D, L + D))
    got = _flash_bf16_emulation(tq, tk, tv, causal=True, window=window)
    want = flash_attention_ref(tq, tk, tv, causal=True, window=window)
    pallas = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                  block_q=64, block_k=64)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("H,KV,L,D,window", [(8, 2, 200, 64, 0),
                                             (8, 2, 77, 80, 64),
                                             (4, 1, 150, 50, 0),
                                             (4, 4, 130, 96, 40)])
def test_flash_bf16_kernel_arithmetic_ragged(H, KV, L, D, window):
    """Lengths off any tile and head dims run in the next instantiated width
    up (50 in 64, 96 in 128): the emulated bf16 kernel against the plain
    version alone (the Pallas wrapper needs whole blocks)."""
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in
                  _flash_inputs(1, H, KV, L, D, L))
    got = _flash_bf16_emulation(tq, tk, tv, causal=True, window=window)
    want = flash_attention_ref(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("D,width", [(1, 64), (50, 64), (64, 64), (65, 80),
                                     (72, 80), (80, 80), (81, 128),
                                     (96, 128), (128, 128)])
def test_flash_attention_head_width(D, width):
    """The bf16 kernel runs 64, 80 and 128 as they are, any other D <= 128
    in the next instantiated width up."""
    assert fa.head_width(D) == width
    assert width in fa.HEAD_WIDTHS


@pytest.mark.parametrize("D", [0, -1, 129, 256])
def test_flash_attention_head_width_refuses(D):
    with pytest.raises(ValueError, match="head dim"):
        fa.head_width(D)


def test_flash_attention_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 2, 8, 16, dtype=torch.bfloat16)
    before = fa.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    assert fa.launches == before


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


@pytest.mark.parametrize("B,L,H,P,N,chunk", [(1, 128, 2, 16, 32, 32),
                                             (2, 64, 3, 32, 16, 64)])
def test_ssd_scan_ref_init_state_rounds_as_the_reference(B, L, H, P, N, chunk):
    """bf16 with an initial state: y is the scan from a zero state rounded
    to bf16, plus the initial state's share added in f32 and rounded again,
    bit for bit, as the reference's wrapper rounds it; the share matches a
    float64 evaluation, the final state is S + exp(cs_L) S0, and port and
    reference agree at the bf16 tolerance of the sweep above."""
    j, t = _ssd_inputs(B, L, H, P, N, "bf16", seed=L + H)
    S0 = (np.random.default_rng(L).standard_normal((B, H, P, N))
          * 0.3).astype(np.float32)
    tS0 = torch.from_numpy(S0)
    y0, S_zero = ssd_scan_ref(*t)
    y, S = ssd_scan_ref(*t, init_state=tS0)
    share = ssd_init_share(t[1], t[2], t[4], tS0)
    assert y.dtype == torch.bfloat16 and share.dtype == torch.float32
    assert torch.equal(y, (y0.float() + share).to(torch.bfloat16))
    dt, A, Cs = (a.double().numpy() for a in (t[1], t[2], t[4]))
    cs = np.cumsum(dt * A, axis=1)                       # (B, L, H)
    want = np.einsum("bln,bhpn,blh->blhp", Cs, S0.astype(np.float64),
                     np.exp(cs))
    np.testing.assert_allclose(share.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        S.numpy(), S_zero.numpy() + S0 * np.exp(cs[:, -1])[:, :, None, None],
        atol=1e-5, rtol=1e-5)
    jy, jS = jops.ssd_scan(*j, chunk=chunk, init_state=jnp.asarray(S0))
    np.testing.assert_allclose(_f32(y), _f32(jy), atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(_f32(S), _f32(jS), atol=5e-2, rtol=5e-2)


def _hi_lo(t):
    """An f32 tensor as a bf16 high part and the bf16 rounding of the rest
    (both returned in f32)."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _ssd_chunk_parallel_emulation(xh, dt, A, Bs, Cs, init_state=None):
    """The CUDA kernels' order of work on the CPU, at their own chunk (128
    steps in bf16 at N <= 16, else 64; the sequence zero-padded to whole
    chunks): (1) every chunk's state S_c = x^T (w B) with w_j = dt_j
    exp(cs_last - cs_j), cs the cumsum of dt A inside the chunk; (2) S_in(c
    + 1) = exp(cs_last(c)) S_in(c) + S_c from zero, the final state
    S_in(n_chunks) (+ exp(cs0_L) S0); (3) y in halves of 64 steps: y = W x +
    exp(cs_i - cs_start) C . S_start with W_ij = (C_i . B_j) exp(cs_i -
    cs_j) dt_j on j <= i inside the half, S_start = S_in for the first half
    and, for the second half of a 128-step chunk, S_mid = exp(cs_63) S_in +
    x^T (w' B) over the first half (w'_j = dt_j exp(cs_63 - cs_j)), cs_start
    = cs_63; with an initial state y rounded, exp(cs0_i) C . S0 added in f32
    and rounded again.  In bf16 every product whose operand the kernels
    make in f32 (w B, W, S_in, S_mid, S0) is the sum of two products, one
    with the operand's bf16 high part and one with the bf16 rounding of the
    rest (the tensor cores' f32 sums taken in float64); bf16 inputs are
    exact.  In f32 the products are f32 matmuls.  Returns (y, final state,
    the initial state's share of y in f32 or None)."""
    B, L, H, P = xh.shape
    N = Bs.shape[-1]
    bf = xh.dtype == torch.bfloat16
    Q = 128 if bf and N <= 16 else 64
    nc = -(-L // Q)
    pad = nc * Q - L

    def chunks(t):                      # (B, L, ...) -> (B, nc, Q, ...)
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2)
                                    + (0, pad))
        return t.reshape(B, nc, Q, *t.shape[2:])

    def prod(exact, made):
        """exact @ made, made an f32 operand the kernel makes."""
        if not bf:
            return exact @ made
        hi, lo = _hi_lo(made)
        e = exact.double()
        return (e @ hi.double() + e @ lo.double()).float()

    x = chunks(xh).permute(0, 3, 1, 2, 4)                 # (B, H, nc, Q, P)
    d = chunks(dt).permute(0, 3, 1, 2)                    # (B, H, nc, Q)
    Bm, Cm = chunks(Bs)[:, None], chunks(Cs)[:, None]     # (B, 1, nc, Q, N)
    cs = torch.cumsum(d * A.float()[None, :, None, None], dim=-1)
    total = cs[..., -1]                                   # (B, H, nc)
    w = d * torch.exp(total[..., None] - cs)
    S_c = prod(x.transpose(-1, -2), w[..., None] * Bm)    # (B, H, nc, P, N)
    S = torch.zeros((B, H, P, N))
    S_in, cs0, run = [], [], torch.zeros((B, H))
    for c in range(nc):
        S_in.append(S)
        cs0.append(run)
        run = run + total[..., c]
        f = torch.exp(total[..., c])[..., None, None].double()
        S = (f * S.double() + S_c[:, :, c].double()).float()
    S_in, cs0 = torch.stack(S_in, dim=2), torch.stack(cs0, dim=2)
    # the outputs kernel's decay: exp(cs_i - cs_j) = exp(cs_i - cs_m0)
    # exp(cs_m0 - cs_k0) exp(cs_k0 - cs_j), m0 and k0 the first steps of the
    # 16-step blocks of i and j; f_j = dt_j exp(cs_k0 - cs_j)
    blk = cs[..., ::16].repeat_interleave(16, dim=-1)     # cs_m0 / cs_k0
    f = d * torch.exp(blk - cs)
    tri = torch.tril(torch.ones((64, 64), dtype=torch.bool))
    ys, start, cs_start = [], S_in, torch.zeros_like(total)
    for half in range(Q // 64):
        sl = slice(64 * half, 64 * half + 64)
        xq, csq, bq, fq, Bq, Cq = (x[..., sl, :], cs[..., sl],
                                   blk[..., sl], f[..., sl],
                                   Bm[..., sl, :], Cm[..., sl, :])
        if half:                         # S_mid over the first half
            c63 = cs[..., 63]
            w1 = torch.exp(c63[..., None] - blk[..., :64]) * f[..., :64]
            start = (torch.exp(c63)[..., None, None] * S_in
                     + prod(x[..., :64, :].transpose(-1, -2),
                            w1[..., None] * Bm[..., :64, :]))
            cs_start = c63
        G = (Cq.double() @ Bq.double().transpose(-1, -2)).float()
        rows = torch.exp(csq - bq)[..., :, None]          # exp(cs_i - cs_m0)
        expo = bq[..., :, None] - bq[..., None, :]        # cs_m0 - cs_k0
        blocks = torch.exp(torch.where(tri, expo,
                                       torch.full_like(expo, -math.inf)))
        W = torch.where(tri, G * (rows * blocks) * fq[..., None, :],
                        torch.zeros_like(G))
        ys.append(prod(W, xq)
                  + torch.exp(csq - cs_start[..., None])[..., None]
                  * prod(Cq, start.transpose(-1, -2)))
    y = torch.cat(ys, dim=-2)
    share = None
    if init_state is not None:
        S0 = init_state.float()
        S = S + torch.exp(run)[..., None, None] * S0
        share = (torch.exp(cs0[..., None] + cs)[..., None]
                 * prod(Cm, S0[:, :, None].transpose(-1, -2)))
        y = y.to(xh.dtype).float() + share

    def unchunk(t):                     # (B, H, nc, Q, P) -> (B, L, H, P)
        return t.permute(0, 2, 3, 1, 4).reshape(B, nc * Q, H, P)[:, :L]
    if share is not None:
        share = unchunk(share)
    return unchunk(y).to(xh.dtype), S, share


@pytest.mark.parametrize("B,L,H,P,N", [
    (1, 256, 2, 16, 16),     # L a multiple of the kernels' chunks
    (2, 200, 3, 16, 16),     # L a multiple of neither 64 nor 128
    (2, 100, 3, 16, 16),     # L shorter than the bf16 chunk at N 16
    (1, 40, 2, 32, 128),     # L shorter than a chunk, N 128
    (1, 1, 2, 16, 128),      # one step
    (1, 192, 2, 64, 128),    # three chunks at N 128
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunk_parallel_arithmetic_matches_plain_and_pallas(
        B, L, H, P, N, dtype, init):
    """The three CUDA kernels' chunk-parallel form with the bf16 high/low
    split (emulated on the CPU) against the plain version and the Pallas
    kernel (interpret mode): y at the sweep's tolerances (2e-3 f32, 5e-2
    bf16), the final state at 2e-3."""
    j, t = _ssd_inputs(B, L, H, P, N, dtype, seed=L + N + P)
    S0 = ((np.random.default_rng(L).standard_normal((B, H, P, N)) * 0.3)
          .astype(np.float32) if init else None)
    tS0 = None if S0 is None else torch.from_numpy(S0)
    y, S, _ = _ssd_chunk_parallel_emulation(*t, init_state=tS0)
    y_ref, S_ref = ssd_scan_ref(*t, init_state=tS0)
    jy, jS = jops.ssd_scan(*j, chunk=256, init_state=(
        None if S0 is None else jnp.asarray(S0)))
    assert y.dtype == t[0].dtype and y.shape == (B, L, H, P)
    assert S.dtype == torch.float32 and S.shape == (B, H, P, N)
    tol = 5e-2 if dtype == "bf16" else 2e-3
    for want in (_f32(y_ref), _f32(jy)):
        np.testing.assert_allclose(_f32(y), want, atol=tol, rtol=tol)
    for want in (_f32(S_ref), _f32(jS)):
        np.testing.assert_allclose(_f32(S), want, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("L,N", [(200, 16), (100, 128), (1, 16)])
def test_ssd_chunk_parallel_init_state_rounds_twice(L, N):
    """bf16 with an initial state: the kernels' y is their own y from a
    zero state (rounded to bf16), plus the initial state's share added in
    f32 and rounded again, bit for bit; the final state is the zero-state
    one plus exp(cs_L) S0."""
    B, H, P = 1, 2, 16
    _, t = _ssd_inputs(B, L, H, P, N, "bf16", seed=L + N)
    S0 = torch.from_numpy((np.random.default_rng(N).standard_normal(
        (B, H, P, N)) * 0.3).astype(np.float32))
    y0, S_zero, none = _ssd_chunk_parallel_emulation(*t)
    y, S, share = _ssd_chunk_parallel_emulation(*t, init_state=S0)
    assert none is None and share.dtype == torch.float32
    assert torch.equal(y, (y0.float() + share).to(torch.bfloat16))
    cs = torch.cumsum(t[1].double() * t[2].double(), dim=1)[:, -1]  # (B, H)
    np.testing.assert_allclose(
        S.numpy(), (S_zero.double() + torch.exp(cs)[..., None, None]
                    * S0.double()).numpy(), atol=1e-5, rtol=1e-5)


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


# ------------------------------------------- the router kernels' order --
# Test-only emulations of the CUDA router's three routes
# (csrc/moe_router.cu), each summing the logits in its kernel's order in f32
# (an FMA or a tensor-core sum taken in float64, rounded once to f32), then
# the shared top-k: k first-maximum passes and a softmax over the k values.

def _router_topk(logits, k):
    """The kernels' top-k on f32 logits (T, E): the first maximum k times
    (a taken expert becomes -1e30), weights exp(v - v_0) over their sum."""
    work, vals, idxs = logits.clone(), [], []
    for _ in range(k):
        i = torch.argmax(work, dim=-1, keepdim=True)       # first maximum
        vals.append(torch.gather(work, -1, i))
        idxs.append(i)
        work = work.scatter(-1, i, -1e30)
    v = torch.cat(vals, dim=-1)
    p = torch.exp(v - v[:, :1])
    return p / p.sum(dim=-1, keepdim=True), torch.cat(idxs, -1).to(torch.int32)


def _router_split_logits(x, w):
    """The split route (decode): d in S slices of ``rows`` (32 rows for d up
    to 4,096, S ~ 128); in slice s thread (j, e) chains its FMAs over rows
    j, j + J, ... (J = 256 // E), the J sums are added in the order j = 0,
    1, ...; then token t's S partials are added in runs [j c, (j + 1) c) in
    order (c = ceil(S / J)) and the runs in the order j = 0, 1, ..."""
    T, d = x.shape
    E = w.shape[1]
    rows = min(-(-(-(-d // 128)) // 32) * 32, 512)
    S, J = -(-d // rows), 256 // E
    pad = S * rows - d
    xs = torch.nn.functional.pad(x.double(), (0, pad)).reshape(T, S, rows)
    ws = torch.nn.functional.pad(w.double(), (0, 0, 0, pad)).reshape(S, rows,
                                                                     E)
    acc = torch.zeros((S, J, T, E))
    for m in range(-(-rows // J)):
        dd = torch.arange(J) + m * J
        live = dd < rows
        dd = dd.clamp(max=rows - 1)
        prod = xs[:, :, dd].permute(1, 2, 0)[..., None] * ws[:, dd, None, :]
        acc = torch.where(live[None, :, None, None],
                          (acc.double() + prod).float(), acc)
    part = torch.zeros((S, T, E))
    for j in range(J):                  # in the block, j = 0, 1, ...
        part = part + acc[:, j]
    c = -(-S // J)
    logits = torch.zeros((T, E))
    for j in range(J):                  # runs of partials, each in order
        run = torch.zeros((T, E))
        for s in range(min(S, j * c), min(S, j * c + c)):
            run = run + part[s]
        logits = logits + run
    return logits


def _router_mma_logits(x, w):
    """The mma route (bf16 prefill): d in tiles of TK (128 at E <= 16, else
    64); 8 // MG k parts (MG = E_pad / 16), each a contiguous run of 16 KB
    d of the tile; per tile and part the exact product (x . (hi + mid + lo)
    = x . W) rounded to f32 is added to the part's running sum; the parts
    are added in order at the end."""
    T, d = x.shape
    E = w.shape[1]
    EP = 16 if E <= 16 else 32 if E <= 32 else 64 if E <= 64 else 128
    KP = 8 // (EP // 16)
    KB = 1 if KP >= 4 else 4 // KP
    TK = 16 * KP * KB
    nk = -(-d // TK)
    pad = nk * TK - d
    xs = torch.nn.functional.pad(x.double(), (0, pad)).reshape(T, nk, KP,
                                                               TK // KP)
    ws = torch.nn.functional.pad(w.double(), (0, 0, 0, pad)).reshape(
        nk, KP, TK // KP, E)
    chunks = torch.einsum("tnpc,npce->npte", xs, ws).float()
    tot = torch.zeros((KP, T, E))
    for kt in range(nk):
        tot = tot + chunks[kt]
    logits = tot[0]
    for h in range(1, KP):
        logits = logits + tot[h]
    return logits


def _router_tiled_logits(x, w):
    """The tiled route (f32 prefill): one FMA chain over d = 0, 1, ... a
    logit."""
    xd, wd = x.double(), w.double()
    acc = torch.zeros((x.shape[0], w.shape[1]))
    for c in range(x.shape[1]):
        acc = (acc.double() + xd[:, c, None] * wd[c]).float()
    return acc


_ROUTER_ROUTES = {"split": _router_split_logits, "mma": _router_mma_logits,
                  "tiled": _router_tiled_logits}


def _router_agrees(got_w, got_i, want_w, want_i, logits, k):
    """Where the k-th and (k+1)-th logits are more than 1e-4 apart, the same
    expert set and weights within 1e-5; where every gap among the top k + 1
    is, the same experts in the same order."""
    E = logits.shape[1]
    top = torch.sort(logits, dim=-1, descending=True).values
    gaps = top[:, :min(k + 1, E)].diff(dim=-1).neg()
    set_sep = (gaps[:, k - 1] > 1e-4 if k < E
               else torch.ones(len(top), dtype=torch.bool))
    ord_sep = (gaps > 1e-4).all(dim=-1)
    assert set_sep.float().mean() > 0.9 or len(set_sep) < 100
    np.testing.assert_array_equal(got_i[set_sep].sort(-1).values.numpy(),
                                  want_i[set_sep].sort(-1).values.numpy())
    np.testing.assert_array_equal(got_i[ord_sep].numpy(),
                                  want_i[ord_sep].numpy())
    np.testing.assert_allclose(got_w[set_sep].numpy(),
                               want_w[set_sep].numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("T", [1, 4, 300, 512])
@pytest.mark.parametrize("d,E,k", [(4096, 16, 2), (1024, 32, 8),
                                   (512, 128, 8)])
@pytest.mark.parametrize("route", ["split", "mma", "tiled"])
def test_moe_router_kernel_order_matches_plain_and_pallas(T, d, E, k, route):
    """Each route's order of work (emulated on the CPU) against the plain
    version and the Pallas kernel (interpret mode, one block for any T):
    indices equal wherever the gaps exceed 1e-4, weights within 1e-5.  The
    mma route takes bf16 x, split and tiled f32 x."""
    rng = np.random.default_rng(T + d + E)
    a = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((d, E)) * 0.1 / np.sqrt(d)).astype(np.float32)
    dtype = "bf16" if route == "mma" else "f32"
    jx, tx = _pair(a, dtype)
    tw = torch.from_numpy(w)
    logits = _ROUTER_ROUTES[route](tx, tw)
    got_w, got_i = _router_topk(logits, k)
    ref_w, ref_i = moe_router_ref(tx, tw, k)
    jw, ji = jops.moe_router(jx, jnp.asarray(w), k)
    plain = tx.double() @ tw.double()
    _router_agrees(got_w, got_i, ref_w, ref_i, plain, k)
    _router_agrees(got_w, got_i, torch.from_numpy(np.array(jw)),
                   torch.from_numpy(np.array(ji)), plain, k)


@pytest.mark.parametrize("route", ["split", "mma", "tiled"])
@pytest.mark.parametrize("T", [4, 300])
def test_moe_router_kernel_order_ties_duplicated_experts(route, T):
    """Duplicated router columns: each route's emulated logits are the same
    bits for both copies, the top-k takes the lower copy first, and the
    result equals the plain version's and the Pallas kernel's exactly."""
    x, w = _router_inputs(T, 256, 16, seed=T, dup=True)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    if route == "mma":
        tx = tx.bfloat16()
    logits = _ROUTER_ROUTES[route](tx, tw)
    assert torch.equal(logits[:, 8:], logits[:, :8])
    got_w, got_i = _router_topk(logits, 2)
    assert (got_i[:, 1] == got_i[:, 0] + 8).all()
    ref_w, ref_i = moe_router_ref(tx, tw, 2)
    jw, ji = jops.moe_router(jnp.asarray(tx.float().numpy(), DTYPES[
        "bf16" if route == "mma" else "f32"][0]), jnp.asarray(w), 2)
    assert torch.equal(got_i, ref_i)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(got_w.numpy(), ref_w.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(jw), atol=1e-5)
